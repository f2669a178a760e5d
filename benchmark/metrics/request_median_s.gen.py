"""The median time between consecutive finished requests in the window
(host clock; one deep, so it is the pipeline's rate, not a latency)."""
import statistics


def read(record):
    return statistics.median(record["request_s"]) if record["request_s"] else None
