"""Operators, streaming (exec/streaming.py): tiles a worker ran of its
streamed fragments in the window, the program's `stream_tile` spans, per
query.  Nothing to read from a program that spans no scheduling
(`schedule` came with `stream_tile`), or from a window of no query."""


def read(record):
    names = [s["name"] for s in record["spans"]]
    if not record["queries"] or "schedule" not in names:
        return None
    return names.count("stream_tile") / record["queries"]
