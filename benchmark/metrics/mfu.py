"""The whole window's share of the card's bf16 peak: the operations of the
completed work, counted from the cell's shapes, over the window's seconds
times 989 TFLOP/s; for `mfu.gen` and `mfu.train` alike."""
from benchmark import work


def read(record):
    return 100.0 * record["flops"] / (record["window_s"] * work.PEAK_BF16_FLOPS)
