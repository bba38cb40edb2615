"""Wire serialization: page frames (data plane) and plan JSON (control plane).

Counterpart of trino_tpu/serde.py.  The frame format is the same, so
either package reads the other's frames; the result cache spills its
cold entries as these frames, and a worker's output buffers hold them.
A page whose lanes lie on the card is copied to the host once: every
lane is packed into one device buffer and that buffer crosses to the
host in one copy, not one per column.

Plan JSON mirrors the reference's Jackson-serialized PlanFragment shipped
in TaskUpdateRequest (server/remotetask/HttpRemoteTask.java:722): every
plan node / expression / type is a dataclass encoded by a registry key
(``type.*``, ``ir.*``, ``plan.*``, ``sort.SortKey``, ``spi.Split``) that
does not name the package, so the port's JSON of a plan is the JAX
package's text for the same plan.

Reference parity: the frame layout mirrors
execution/buffer/PagesSerdeUtil.java:48-52: ``positionCount |
codecMarkers | uncompressedSize | compressedSize | checksum | payload``
where the payload is blockCount + per-block encodings.  Compression
(zstandard, when installed) is applied only when the ratio beats 0.8
(PageSerializer.java:100).  `TPG2` frames carry a CRC32 of the header
fields and body, and `deserialize_page` raises a typed
`PageIntegrityError` on any mismatch.  Column payloads are raw little-endian
numpy buffers.
"""
from __future__ import annotations

import dataclasses
import io
import json
import struct
import zlib
from decimal import Decimal
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

try:
    import threading as _threading

    import zstandard as _zstd

    _ZSTD_LOCAL = _threading.local()

    def _compressor():
        # zstd (de)compressor objects are NOT thread-safe; tasks serialize
        # pages concurrently, so keep one per thread
        c = getattr(_ZSTD_LOCAL, "c", None)
        if c is None:
            c = _ZSTD_LOCAL.c = _zstd.ZstdCompressor(level=1)
        return c

    def _decompressor():
        d = getattr(_ZSTD_LOCAL, "d", None)
        if d is None:
            d = _ZSTD_LOCAL.d = _zstd.ZstdDecompressor()
        return d

except ImportError:  # pragma: no cover
    _compressor = None
    _decompressor = None

from . import types as T
from .expr import ir
from .ops.sort import SortKey
from .page import Column, Page
from .plan import nodes as P
from .spi import Split

MAGIC = b"TPG2"  # checksummed frames (CRC32 of header fields + body)
MARKER_COMPRESSED = 1
MIN_COMPRESS_BYTES = 4096
COMPRESS_RATIO = 0.8
_HEADER_FIELDS = struct.Struct("<iBII")
HEADER_V2 = 4 + _HEADER_FIELDS.size + 4  # magic + fields + crc32


class PageIntegrityError(RuntimeError):
    """A page frame failed structural or checksum validation (the
    reference's PagesSerde checksum mismatch -> GENERIC_INTERNAL_ERROR
    "Checksum verification failure").  Typed so schedulers can treat it
    as retriable: the bytes are wrong, not the query."""

# ---------------------------------------------------------------------------
# Page binary serde (the data plane)
# ---------------------------------------------------------------------------


def _w_bytes(buf: io.BytesIO, b: bytes):
    buf.write(struct.pack("<I", len(b)))
    buf.write(b)


def _r_bytes(mv: memoryview, off: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", mv, off)
    off += 4
    return bytes(mv[off : off + n]), off + n


def _host_lanes(page: Page) -> List[Tuple[np.ndarray, Any]]:
    """(values, validity) of each column's first ``count`` rows as numpy.
    Lanes on the card are packed into one byte buffer there and copied to
    the host in one transfer; host lanes (numpy or CPU tensors) are read
    in place."""
    n = page.count
    lanes = []
    for col in page.columns:
        lanes.append(col.values)
        lanes.append(col.validity)
    dev = [x for x in lanes if isinstance(x, torch.Tensor) and x.device.type != "cpu"]
    if dev:
        parts = [x[:n].contiguous().view(-1).view(torch.uint8) for x in dev]
        flat = torch.cat(parts).cpu().numpy()
        off = 0
        host = {}
        for x, b in zip(dev, parts):
            nb = b.numel()
            dt = np.dtype(str(x.dtype).replace("torch.", ""))
            host[id(x)] = flat[off:off + nb].view(dt).reshape(
                (min(n, x.shape[0]),) + tuple(x.shape[1:]))
            off += nb
        lanes = [host.get(id(x), x) for x in lanes]
    out = []
    for i in range(0, len(lanes), 2):
        v, ok = lanes[i], lanes[i + 1]
        if isinstance(v, torch.Tensor):
            v = v.numpy()
        if isinstance(ok, torch.Tensor):
            ok = ok.numpy()
        out.append((np.asarray(v)[:n], None if ok is None else np.asarray(ok)[:n]))
    return out


def serialize_page(page: Page) -> bytes:
    """Page -> one wire frame (only the first ``count`` rows are shipped)."""
    n = page.count
    payload = io.BytesIO()
    payload.write(struct.pack("<I", page.num_columns))
    names = page.names or [f"c{i}" for i in range(page.num_columns)]
    for name, col, (host_vals, host_ok) in zip(names, page.columns,
                                               _host_lanes(page)):
        _w_bytes(payload, name.encode())
        _w_bytes(payload, str(col.type).encode())
        vals = np.ascontiguousarray(host_vals)
        flags = 0
        if col.validity is not None:
            flags |= 1
        if col.dictionary is not None:
            flags |= 2
        if vals.ndim == 2:
            flags |= 4  # wide (two-limb) decimal rows
        payload.write(struct.pack("<B", flags))
        _w_bytes(payload, vals.dtype.str.encode())
        _w_bytes(payload, vals.tobytes())
        if col.validity is not None:
            ok = np.ascontiguousarray(host_ok.astype(np.uint8))
            _w_bytes(payload, np.packbits(ok).tobytes())
        if col.dictionary is not None:
            entries = [str(s) for s in col.dictionary]
            payload.write(struct.pack("<I", len(entries)))
            for s in entries:
                _w_bytes(payload, s.encode())
    raw = payload.getvalue()
    markers = 0
    body = raw
    if _compressor is not None and len(raw) >= MIN_COMPRESS_BYTES:
        comp = _compressor().compress(raw)
        if len(comp) < len(raw) * COMPRESS_RATIO:
            markers |= MARKER_COMPRESSED
            body = comp
    fields = _HEADER_FIELDS.pack(n, markers, len(raw), len(body))
    crc = zlib.crc32(body, zlib.crc32(fields)) & 0xFFFFFFFF
    return MAGIC + fields + struct.pack("<I", crc) + body


def deserialize_page(frame: bytes) -> Page:
    magic = bytes(frame[:4])
    if magic == MAGIC:
        if len(frame) < HEADER_V2:
            raise PageIntegrityError(
                f"truncated page frame: {len(frame)} bytes < header"
            )
        fields = bytes(frame[4 : 4 + _HEADER_FIELDS.size])
        n, markers, usize, csize = _HEADER_FIELDS.unpack(fields)
        (crc,) = struct.unpack_from("<I", frame, 4 + _HEADER_FIELDS.size)
        body = bytes(frame[HEADER_V2 : HEADER_V2 + csize])
        if len(body) != csize:
            raise PageIntegrityError(
                f"truncated page frame body: {len(body)}/{csize} bytes"
            )
        actual = zlib.crc32(body, zlib.crc32(fields)) & 0xFFFFFFFF
        if actual != crc:
            raise PageIntegrityError(
                f"page frame CRC mismatch: stored {crc:#010x}, "
                f"computed {actual:#010x}"
            )
    else:
        raise PageIntegrityError(f"bad page frame magic {magic!r}")
    if markers & MARKER_COMPRESSED:
        body = _decompressor().decompress(body, max_output_size=usize)
    mv = memoryview(body)
    (ncols,) = struct.unpack_from("<I", mv, 0)
    off = 4
    names: List[str] = []
    cols: List[Column] = []
    for _ in range(ncols):
        nm, off = _r_bytes(mv, off)
        ts, off = _r_bytes(mv, off)
        (flags,) = struct.unpack_from("<B", mv, off)
        off += 1
        dt, off = _r_bytes(mv, off)
        vb, off = _r_bytes(mv, off)
        vals = np.frombuffer(vb, dtype=np.dtype(dt.decode())).copy()
        if flags & 4:
            vals = vals.reshape(-1, 2)
        validity = None
        if flags & 1:
            bb, off = _r_bytes(mv, off)
            validity = np.unpackbits(
                np.frombuffer(bb, dtype=np.uint8), count=n
            ).astype(bool)
        dictionary = None
        if flags & 2:
            (nd,) = struct.unpack_from("<I", mv, off)
            off += 4
            entries = []
            for _ in range(nd):
                e, off = _r_bytes(mv, off)
                entries.append(e.decode())
            dictionary = np.array(entries, dtype=object)
        names.append(nm.decode())
        cols.append(Column(T.parse_type(ts.decode()), vals, validity, dictionary))
    return Page(cols, n, names)


def serialize_pages(pages: List[Page]) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack("<I", len(pages)))
    for p in pages:
        _w_bytes(buf, serialize_page(p))
    return buf.getvalue()


def pages_stats(data: bytes) -> Tuple[int, int]:
    """(rows, uncompressed bytes) of a serialized page stream, read from
    the frame HEADERS only — no decompression.  The adaptive planner's
    OutputStatsEstimator input: compressed file sizes lie about relative
    volumes (zstd flattens monotone int columns ~10x)."""
    mv = memoryview(data)
    (n,) = struct.unpack_from("<I", mv, 0)
    off = 4
    rows = 0
    ubytes = 0
    for _ in range(n):
        frame, off = _r_bytes(mv, off)
        # the CRC32 follows the fields, which stats never read
        if frame[:4] != MAGIC:
            raise PageIntegrityError(
                f"bad page frame magic {bytes(frame[:4])!r}"
            )
        cnt, _markers, usize, _csize = _HEADER_FIELDS.unpack_from(frame, 4)
        rows += cnt
        ubytes += usize
    return rows, ubytes


def deserialize_pages(data: bytes) -> List[Page]:
    mv = memoryview(data)
    (n,) = struct.unpack_from("<I", mv, 0)
    off = 4
    out = []
    for _ in range(n):
        frame, off = _r_bytes(mv, off)
        out.append(deserialize_page(frame))
    return out


# ---------------------------------------------------------------------------
# Plan JSON serde (the control plane)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}


def _register(module, prefix: str):
    for name, obj in vars(module).items():
        if isinstance(obj, type) and dataclasses.is_dataclass(obj):
            _REGISTRY[f"{prefix}.{name}"] = obj


_register(T, "type")
_register(ir, "ir")
_register(P, "plan")
_REGISTRY["sort.SortKey"] = SortKey
_REGISTRY["spi.Split"] = Split


def _cls_key(obj) -> str:
    cls = type(obj)
    for key, c in _REGISTRY.items():
        if c is cls:
            return key
    raise TypeError(f"unregistered dataclass {cls.__name__}")


def encode_value(v: Any) -> Any:
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, Decimal):
        return {"$dec": str(v)}
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    if isinstance(v, dict):
        return {"$dict": [[encode_value(k), encode_value(x)] for k, x in v.items()]}
    if dataclasses.is_dataclass(v):
        doc = {"$": _cls_key(v)}
        for f in dataclasses.fields(v):
            doc[f.name] = encode_value(getattr(v, f.name))
        return doc
    raise TypeError(f"cannot encode {type(v).__name__}: {v!r}")


def decode_value(v: Any) -> Any:
    if v is None or isinstance(v, (bool, str, int, float)):
        return v
    if isinstance(v, list):
        return tuple(decode_value(x) for x in v)
    if isinstance(v, dict):
        if "$dec" in v:
            return Decimal(v["$dec"])
        if "$dict" in v:
            return {decode_value(k): decode_value(x) for k, x in v["$dict"]}
        cls = _REGISTRY[v["$"]]
        kwargs = {k: decode_value(x) for k, x in v.items() if k != "$"}
        return cls(**kwargs)
    raise TypeError(f"cannot decode {v!r}")


def plan_to_json(node: P.PlanNode) -> str:
    return json.dumps(encode_value(node))


def plan_from_json(s: str) -> P.PlanNode:
    return decode_value(json.loads(s))
