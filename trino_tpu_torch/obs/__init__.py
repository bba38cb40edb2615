"""Observability of one query: per-operator frames (opstats.py) and the
device-memory bandwidth ledger (bandwidth.py)."""
