"""Network evaluations a request, from the pipeline's own count read after
each finished request."""


def read(record):
    return sum(record["nfe"]) / len(record["nfe"]) if record["nfe"] else None
