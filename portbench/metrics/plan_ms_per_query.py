"""Frontend (session.py, sql/, plan/): milliseconds of the program's
`parse`, `analyze_plan` and `optimize` spans in the window, per query.
A plan the session's plan cache holds costs only its parse."""

SPANS = ("parse", "analyze_plan", "optimize")


def read(record):
    spans = [s for s in record["spans"] if s["name"] in SPANS]
    if not spans or not record["queries"]:
        return None
    return sum(s["end"] - s["start"] for s in spans) * 1e3 / record["queries"]
