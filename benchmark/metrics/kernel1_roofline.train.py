"""Kernel 1 in training (forward with each row's log-sum-exp) against its
roofline in the traced steps."""
from benchmark import work
from benchmark.metrics._common import roofline

NAMES = ("attention_tma_kernel", "attention_mma_kernel")


def read(record):
    return roofline(record, NAMES, lambda b, l, h, d: work.attention_fwd(b, l, h, d, True),
                    exclude=("true",))
