"""Operators (exec/local.py `_run_plan`, the retry ladder): re-runs of a
plan in the window, the program's `plan_run` spans of attempt 1 or later
(a runtime check fired in the run before: `rerun` names it), per query.
Nothing to read from a program that spans no plan run."""


def read(record):
    attempts = [s["attributes"].get("attempt", 0) for s in record["spans"]
                if s["name"] == "plan_run"]
    if not attempts or not record["queries"]:
        return None
    return sum(1 for a in attempts if a >= 1) / record["queries"]
