"""Auxiliary services (reference service/ modules: trino-verifier,
trino-proxy).  Counterpart of trino_tpu/services (copied)."""
