"""Kernel 2 (`fused_attention_qkv_vjp`, the attention's backward: a dq and a
dkv launch a call) against its roofline in the traced steps."""
from benchmark import work
from benchmark.metrics._common import roofline

NAMES = ("dq_tma_kernel", "dkv_tma_kernel", "dq_kernel", "dkv_kernel")


def read(record):
    return roofline(record, NAMES, work.attention_bwd)
