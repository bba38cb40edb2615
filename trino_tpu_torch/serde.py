"""Page frames: the binary serialization of a Page.

Counterpart of the data-plane half of trino_tpu/serde.py (the frame
format is the same, so either package reads the other's frames; the
plan JSON of the control plane waits for the distributed slices).  The
result cache spills its cold entries as these frames.

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

import io
import struct
import zlib
from typing import List, Tuple

import numpy as np

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
from .page import Column, Page

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


def serialize_page(page: Page) -> bytes:
    """Page -> one wire frame (only the first ``count`` rows are shipped)."""
    n = page.count
    payload = io.BytesIO()
    payload.write(struct.pack("<I", page.num_columns))
    names = page.names or [f"c{i}" for i in range(page.num_columns)]
    for name, col in zip(names, page.columns):
        _w_bytes(payload, name.encode())
        _w_bytes(payload, str(col.type).encode())
        vals = np.ascontiguousarray(np.asarray(col.values)[:n])
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
            ok = np.ascontiguousarray(
                np.asarray(col.validity)[:n].astype(np.uint8)
            )
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
