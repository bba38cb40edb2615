"""Observability: per-operator frames (opstats.py), the device-memory
bandwidth ledger (bandwidth.py), the incident journal (journal.py) and
the flight recorder of supervised device work (flight_recorder.py)."""
from . import journal  # noqa: F401
