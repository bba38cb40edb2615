"""Exchange (exec/exchange_client.py): milliseconds of the program's
`exchange_transfer` spans in the window, per query.  One such span reads
the body of one answered pull of an upstream buffer: the frame's bytes
on the wire, after the producer's wait (the polls and the server's
long-poll, which end when the response's headers come) and before the
decode, which `serde_ms_per_query` reads.  Pulls run side by side on a
worker's fetch threads, and their transfers are summed.  Nothing to read
from a program without the span."""


def read(record):
    spans = [s for s in record["spans"] if s["name"] == "exchange_transfer"]
    if not spans or not record["queries"]:
        return None
    return sum(s["end"] - s["start"] for s in spans) * 1e3 / record["queries"]
