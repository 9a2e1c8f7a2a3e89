"""Minimal OpenEXR scanline reader/writer (no external EXR dependency).

Counterpart of the reference's ``readEXR_onlydepth`` (reference:
datas/common.py:23-56, used by slam_datasets.py:102-103 for '.exr' depth
frames). That code needs the OpenEXR + Imath packages, which are not
dependencies here, and OpenCV builds often lack the EXR codec, so dnsjax
carries a small reader for the subset depth captures actually use: single-part
scanline images, NO/ZIPS/ZIP compression, HALF or FLOAT channels.

``read_exr_depth`` returns the 'Y' channel if present (as the reference
does), else the first channel, as float32 (H, W).

The port's own copy of dnsjax/data/exr.py, equal to it (the port imports nothing of
dnsjax; tests/test_torch_shared.py holds the two together).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = 0x01312F76
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
# scanlines per chunk by compression id
_BLOCK_LINES = {0: 1, 1: 1, 2: 1, 3: 16}


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def _unzip_block(data: bytes) -> bytes:
    """OpenEXR ZIP: inflate, undo the delta predictor, de-interleave."""
    raw = bytearray(zlib.decompress(data))
    for i in range(1, len(raw)):
        raw[i] = (raw[i] + raw[i - 1] - 128) & 0xFF
    half = (len(raw) + 1) // 2
    out = bytearray(len(raw))
    out[0::2] = raw[:half]
    out[1::2] = raw[half:]
    return bytes(out)


def _parse_header(buf: bytes):
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    off = 8
    attrs: Dict[str, tuple] = {}
    while buf[off] != 0:
        name, off = _read_cstr(buf, off)
        atype, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name] = (atype, buf[off : off + size])
        off += size
    return attrs, off + 1


def _parse_channels(raw: bytes):
    """chlist bytes -> [(name, numpy dtype, bytes/px)] in file order."""
    off = 0
    channels = []
    while raw[off] != 0:
        name, off = _read_cstr(raw, off)
        ptype, _plin, _xs, _ys = struct.unpack_from("<iB3xii", raw, off)
        off += 16
        dt = _PIXEL_DTYPES[ptype]
        channels.append((name, dt, np.dtype(dt).itemsize))
    return channels


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Read every channel of a scanline EXR as float32 (H, W) arrays."""
    with open(path, "rb") as f:
        buf = f.read()
    attrs, off = _parse_header(buf)
    channels = _parse_channels(attrs["channels"][1])
    (comp,) = struct.unpack_from("<B", attrs["compression"][1], 0)
    if comp not in _BLOCK_LINES:
        raise ValueError(f"unsupported EXR compression id {comp}")
    x0, y0, x1, y1 = struct.unpack_from("<4i", attrs["dataWindow"][1], 0)
    W, H = x1 - x0 + 1, y1 - y0 + 1

    lines = _BLOCK_LINES[comp]
    n_chunks = (H + lines - 1) // lines
    off += 8 * n_chunks  # skip the chunk-offset table; chunks follow in order

    row_bytes = W * sum(c[2] for c in channels)
    out = {name: np.empty((H, W), np.float32) for name, _, _ in channels}
    for _ in range(n_chunks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        data = buf[off : off + size]
        off += size
        n_rows = min(lines, y1 - y + 1)
        # ZIP chunks whose compressed form would be larger are stored raw
        if comp in (2, 3) and len(data) != n_rows * row_bytes:
            data = _unzip_block(data)
        if len(data) != n_rows * row_bytes:
            raise ValueError("EXR chunk size mismatch")
        pos = 0
        for r in range(n_rows):
            for name, dt, isz in channels:
                row = np.frombuffer(data, dt, count=W, offset=pos)
                out[name][y - y0 + r] = row.astype(np.float32)
                pos += W * isz
    return out


def read_exr_depth(path: str) -> np.ndarray:
    """Depth buffer: the 'Y' channel if present (reference semantics,
    datas/common.py:54-56), else the first channel."""
    chans = read_exr(path)
    if "Y" in chans:
        return chans["Y"]
    return next(iter(chans.values()))


def write_exr(path: str, img: np.ndarray, channel: str = "Y") -> None:
    """Write a single-channel float32 scanline EXR (ZIP compression)."""
    img = np.ascontiguousarray(img, np.float32)
    H, W = img.shape

    def attr(name, atype, data):
        return name.encode() + b"\0" + atype.encode() + b"\0" + struct.pack("<i", len(data)) + data

    chlist = channel.encode() + b"\0" + struct.pack("<iB3xii", 2, 0, 1, 1) + b"\0"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = b"".join(
        [
            struct.pack("<iI", _MAGIC, 2),
            attr("channels", "chlist", chlist),
            attr("compression", "compression", b"\x03"),  # ZIP
            attr("dataWindow", "box2i", box),
            attr("displayWindow", "box2i", box),
            attr("lineOrder", "lineOrder", b"\x00"),
            attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
            attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )

    chunks = []
    for y in range(0, H, 16):
        rows = img[y : y + 16]
        raw = bytearray(rows.tobytes())
        half = (len(raw) + 1) // 2
        inter = bytearray(len(raw))
        inter[:half] = raw[0::2]
        inter[half:] = raw[1::2]
        for i in range(len(inter) - 1, 0, -1):
            inter[i] = (inter[i] - inter[i - 1] + 128) & 0xFF
        comp = zlib.compress(bytes(inter))
        if len(comp) >= len(raw):  # EXR stores raw if compression doesn't help
            comp = bytes(raw)
        chunks.append(struct.pack("<ii", y, len(comp)) + comp)

    base = len(header) + 8 * len(chunks)
    offsets, pos = [], base
    for c in chunks:
        offsets.append(struct.pack("<Q", pos))
        pos += len(c)
    with open(path, "wb") as f:
        f.write(header)
        f.writelines(offsets)
        f.writelines(chunks)
