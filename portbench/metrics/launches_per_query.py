"""Operators (exec/local.py, ops/, expr/): device kernels the profiler
saw launched in the window (copies and fills left out), per query."""


def read(record):
    dev = record.get("device")
    if not dev or not record["queries"]:
        return None
    return dev["launches"] / record["queries"]
