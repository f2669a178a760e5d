"""The share of the traced slice's wall time in which no device operation
ran (the union of the device rows' intervals against the slice); for
`idle_share.gen` and `idle_share.train` alike."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
