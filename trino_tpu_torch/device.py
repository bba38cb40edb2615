"""Device resolution and dtype rules of the PyTorch port.

Every entry point of the port runs on the CUDA card unless the caller
asks for the CPU (``device="cpu"``, as the CPU tests do).  Without a
card and without that request, ``resolve`` raises: the port never
drops to the CPU on its own.

Dtype rules (the same lane layout as the JAX package's types.py):
BIGINT and short DECIMAL lanes are int64, DOUBLE is float64, VARCHAR is
int32 dictionary codes, DATE is int32 days, BOOLEAN is bool.  Every
tensor the port makes names its dtype and device explicitly, so PyTorch's
float32 default never reaches a lane.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device the port runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and no card
    is present."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU"
        )
    return d


def torch_dtype(np_dtype) -> torch.dtype:
    """Torch dtype of a numpy dtype (lane storage types only)."""
    dt = np.dtype(np_dtype)
    if dt not in _NP_TO_TORCH:
        raise TypeError(f"no device lane dtype for {dt}")
    return _NP_TO_TORCH[dt]


def to_device(arr: np.ndarray, device: torch.device, pin: bool = False):
    """Host numpy array -> tensor on `device`.  With ``pin`` (CUDA only)
    the copy goes through page-locked host memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
