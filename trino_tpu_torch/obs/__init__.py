"""Observability: per-operator frames (opstats.py), the device-memory
bandwidth ledger (bandwidth.py), the incident journal (journal.py), the
flight recorder of supervised device work (flight_recorder.py), the
crash-safe query history (history.py), the compile observatory
(compile_observatory.py), the serving observatory's census, affinity
and SLOs (serving_observatory.py) and the query doctor (doctor.py),
which joins them into one verdict a query."""
from . import journal  # noqa: F401
