"""Seconds from the process's start to the first timed request: the
deployment brought up (kernels built or loaded, scans generated) and
each query template warmed once."""


def read(record):
    return record["setup_s"]
