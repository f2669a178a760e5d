"""The median step time over `fit`'s own log intervals inside the window
(its metrics.jsonl steps_per_sec, host clock), in ms."""
import statistics


def read(record):
    rates = record.get("steps_per_sec") or []
    return 1e3 / statistics.median(rates) if rates else None
