"""Operators (exec/local.py `_TraceCtx.visit`, ops/kernels.py launches,
through runtime/supervisor.py `dispatch`): the share of the traced window
in which the card was idle while the innermost program span open was an
operator visit or a kernel launch (`operator`, `launch`), in percent: the
host's own dispatch between the card's work.

Two limits of the trace's reduction (core/trace.py) hold here: it keeps
the ten span names with the most idle time, so a name that fell off the
list counts as 0 (it held less than the tenth); and a gap that straddles
two spans goes wholly to the span open at its midpoint.  Nothing to read
without a device trace, or from a program that opens none of the spans."""

SPANS = ("operator", "launch")


def read(record):
    dev = record.get("device")
    if not dev or dev["window_s"] <= 0 or not any(s["name"] in SPANS for s in record["spans"]):
        return None
    return 100.0 * sum(s for name, s in dev["idle_gaps"] if name in SPANS) / dev["window_s"]
