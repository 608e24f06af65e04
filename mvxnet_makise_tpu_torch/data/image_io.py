"""PNG read and write in numpy and ``zlib``, with ``cv2.imread``'s result.

The JAX package reads KITTI images and the GT database's patches with
OpenCV; the port keeps no OpenCV dependency.  :func:`read_png` returns what
``cv2.imread(path)`` returns for the PNGs it supports: an (H, W, 3) uint8
array in **BGR** order (gray is replicated, alpha dropped), or None for a
missing or undecodable file.  Supported: 8-bit gray, gray+alpha, RGB, RGBA
and palette images, not interlaced; anything else raises ``ValueError``.

Unfiltering.  The None, Sub and Up filters vectorize along a row (Sub is
a running sum mod 256), but Average and Paeth predict each pixel from its
left neighbour after that neighbour is decoded.  Pixel (y, x) depends only
on (y, x-1), (y-1, x) and (y-1, x-1), so all pixels of one anti-diagonal
y + x = d are independent: the h rows from the first Average or Paeth row
to the last are decoded in h + W - 1 steps, each vectorized across those
rows whatever their filters; the rows outside that block, one row at a
time.  In a skewed copy of the block (row y shifted right by y) a
diagonal is one column, and its three neighbours are slices of the two
columns before it.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_block(filt: np.ndarray, kind: np.ndarray,
                    prior: np.ndarray) -> np.ndarray:
    """Undo the filters ``kind`` (h,) of a block of rows ``filt`` (h, W, C)
    below the decoded row ``prior`` (W, C), one anti-diagonal at a time
    (module docstring)."""
    h, width, channels = filt.shape
    # skewed layout: block row y at skew row y + 1 and skew column
    # x + y + 1 (diagonal d in column d + 1), the prior row at skew row 0,
    # columns 0..W-1; cells off the image stay 0, which is what the
    # filters read there
    span = width + h - 1
    ys = np.arange(h)[:, None]
    cols = np.arange(width)[None, :] + ys
    skew_f = np.zeros((h + 1, span, channels), np.int16)
    skew_f[ys + 1, cols] = filt
    skew = np.zeros((h + 1, span + 1, channels), np.int16)
    skew[0, :width] = prior
    # the filters present, each with its rows (the first needs no mask)
    present = [(int(k), (kind == k)[:, None]) for k in np.unique(kind)]
    zero = np.zeros((1, channels), np.int16)
    for d in range(span):
        y0, y1 = max(0, d - width + 1), min(h - 1, d) + 1
        a = skew[y0 + 1:y1 + 1, d]            # left: (y, x - 1)
        b = skew[y0:y1, d]                    # up: (y - 1, x)
        c = skew[y0:y1, d - 1] if d else zero  # up-left: (y - 1, x - 1)
        pred = None
        for k, rows in present:
            if k == 4:                        # Paeth
                bc, ac = b - c, a - c
                pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
                p = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
            else:                             # None, Sub, Up, Average
                p = (0, a, b, (a + b) >> 1)[k]
            pred = p if pred is None else np.where(rows[y0:y1], p, pred)
        skew[y0 + 1:y1 + 1, d + 1] = (skew_f[y0 + 1:y1 + 1, d] + pred) & 255
    return skew[ys + 1, cols + 1].astype(np.uint8)


def _unfilter(raw: np.ndarray, height: int, width: int,
              channels: int) -> np.ndarray:
    """Undo the per-row PNG filters of ``raw`` (height rows of 1 + width *
    channels bytes) into (height, width, channels) uint8: the rows from
    the first Average or Paeth row to the last as one block
    (:func:`_unfilter_block`), every other row on its own."""
    rows = raw.reshape(height, 1 + width * channels)
    kind = rows[:, 0]
    if (kind > 4).any():
        raise ValueError(f"bad PNG filter type {int(kind.max())}")
    filt = rows[:, 1:].reshape(height, width, channels)
    out = np.zeros((height + 1, width, channels), np.uint8)  # row 0: zero
    serial = np.nonzero(kind >= 3)[0]
    y = 0
    while y < height:
        if len(serial) and y == serial[0]:
            end = serial[-1] + 1
            out[y + 1:end + 1] = _unfilter_block(filt[y:end], kind[y:end],
                                                 out[y])
            y = end
            continue
        if kind[y] == 0:
            out[y + 1] = filt[y]
        elif kind[y] == 1:                    # Sub: running sum mod 256
            out[y + 1] = np.cumsum(filt[y], axis=0, dtype=np.uint8)
        else:                                 # Up
            out[y + 1] = filt[y] + out[y]
        y += 1
    return out[1:]


def _decode(data: bytes) -> np.ndarray:
    """PNG bytes (signature checked) -> (H, W, 3) uint8 BGR (module
    docstring)."""
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype} (8-bit gray, gray+alpha, RGB, RGBA and "
                         f"palette are supported)")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    channels = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (1 + width * channels):
        raise ValueError("truncated PNG image data")
    px = _unfilter(raw[:height * (1 + width * channels)], height, width,
                   channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        rgb = palette[px[..., 0]]
    elif channels <= 2:                       # gray, gray + alpha
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:                                     # RGB, RGBA
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def read_png(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 BGR image of the PNG at ``path``, or None when the
    file is missing or is not a PNG (as ``cv2.imread``).  Raises
    ``ValueError`` for a PNG variant that is not supported."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        return None
    return _decode(data)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, bgr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 BGR image as an 8-bit RGB PNG (rows
    unfiltered), readable by :func:`read_png` and ``cv2.imread``."""
    bgr = np.asarray(bgr)
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{bgr.shape} {bgr.dtype}")
    h, w, _ = bgr.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = bgr[..., ::-1].reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
