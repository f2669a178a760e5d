"""Kernel 1 (`fused_attention_qkv`, the attention forward from packed qkv)
against its roofline in the traced request: its calls' bound at the cell's
shapes over the device time of its rows."""
from benchmark import work
from benchmark.metrics._common import roofline

NAMES = ("attention_tma_kernel", "attention_mma_kernel")


def read(record):
    return roofline(record, NAMES, work.attention_fwd, exclude=("true",))
