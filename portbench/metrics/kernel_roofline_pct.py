"""Kernels (ops/kernels.py, ops/megakernel.py, csrc/*.cu): the least time
the work of every call of the four CUDA kernel entry points needs
(portbench/core/roofline.py) over the device time those calls took, in
percent.  Nothing to read where no call ran."""


def read(record):
    ks = (record.get("device") or {}).get("kernels") or {}
    least = sum(k["least_s"] for k in ks.values())
    took = sum(k["device_s"] for k in ks.values())
    if not ks or took <= 0:
        return None
    return 100.0 * least / took
