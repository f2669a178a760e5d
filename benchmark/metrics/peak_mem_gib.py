"""The device memory allocated at its highest during the window, GiB; for
`peak_mem_gib.gen` and `peak_mem_gib.train` alike."""


def read(record):
    return record["peak_bytes"] / 2 ** 30
