"""Scan (connectors/tpch.py `device_generation`): milliseconds of the
program's `scan_count` spans in the window, the host's count of the line
rows of a lineitem range that a scan-cache miss generates, per query.
Nothing to read from a program that spans no scan load (`scan_count`
opens only inside `scan_load`)."""


def read(record):
    names = {s["name"] for s in record["spans"]}
    if not record["queries"] or "scan_load" not in names:
        return None
    spans = [s for s in record["spans"] if s["name"] == "scan_count"]
    return sum(s["end"] - s["start"] for s in spans) * 1e3 / record["queries"]
