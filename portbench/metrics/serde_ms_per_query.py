"""Serde (serde.py): milliseconds of the program's `serde_encode` spans
(a worker writing a page to its output buffer) and `serde_decode` spans
(the exchange reading a frame) in the window, per query.  Nothing to
read from a program without them."""

NAMES = ("serde_encode", "serde_decode")


def read(record):
    spans = [s for s in record["spans"] if s["name"] in NAMES]
    if not spans or not record["queries"]:
        return None
    return sum(s["end"] - s["start"] for s in spans) * 1e3 / record["queries"]
