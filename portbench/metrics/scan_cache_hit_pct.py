"""Scan (exec/local.py `_load_one_scan`, `DeviceScanCache`): the share of
the window's scan-cache lookups that hit, from the program's `scan_load`
spans, whose `cache` attribute (hit, miss, uncached) is set by the same
lookup that counts the cache's own hits and misses, in percent.  Nothing
to read where no span looked the cache up."""


def read(record):
    kinds = [s["attributes"].get("cache") for s in record["spans"]
             if s["name"] == "scan_load"]
    hits, misses = kinds.count("hit"), kinds.count("miss")
    if hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
