"""Queries answered over the seconds from the window's start to the last
answer, over all clients: every query sent inside the window counts, and
the time runs until it is answered (a failed query is not an answer)."""


def read(record):
    return record["answered"] / record["span_s"]
