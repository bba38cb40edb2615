"""Histogram helpers of the statistics subsystem (copied: pure Python)."""
