"""Shared by the per-layer readers: device seconds by kernel name in the
traced slice, and the roofline share of an attention kernel there."""
from __future__ import annotations

from benchmark import work


def device_seconds(record, names, exclude=()):
    """Seconds of the traced slice's device rows whose name holds one of
    `names` and none of `exclude`; None without a trace or a matching row."""
    trace = record.get("trace")
    if not trace:
        return None
    rows = [s for n, s in trace["device_s"].items()
            if any(k in n for k in names) and not any(x in n for x in exclude)]
    return sum(rows) if rows else None


def roofline(record, names, cost, exclude=()):
    """100 x (the bound of the slice's calls of a kernel, from the cell's
    shapes) / (its device seconds); `cost(b, l, h, d)` gives (bytes, ops)."""
    seconds = device_seconds(record, names, exclude)
    if not seconds:
        return None
    bound = sum(work.bound_s(*cost(b, l, h, d)) * n
                for b, l, h, d, n in record["trace_attention"])
    return 100.0 * bound / seconds
