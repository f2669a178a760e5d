"""Device ms a step in the foreach kernels of the update: AdamW's moments
and step, the EMA, and the gradient norm (`multi_tensor_apply_kernel`)."""
from benchmark.metrics._common import device_seconds


def read(record):
    seconds = device_seconds(record, ("multi_tensor_apply_kernel",))
    return None if seconds is None else 1e3 * seconds / record["trace_units"]
