"""Coordinator (server/scheduler.py): milliseconds of the program's
`schedule` spans in the window, each from a query's fragmented plan to
every task placed on the workers, per query.  Nothing to read from a
program without them."""


def read(record):
    spans = [s for s in record["spans"] if s["name"] == "schedule"]
    if not spans or not record["queries"]:
        return None
    return sum(s["end"] - s["start"] for s in spans) * 1e3 / record["queries"]
