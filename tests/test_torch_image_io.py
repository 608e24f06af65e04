"""PyTorch port: the PNG codec (``data/image_io.py``) against OpenCV.

``read_png`` must return exactly what ``cv2.imread`` returns (BGR uint8) —
on the mini KITTI tree's images (``tests/test_data.write_mini_kitti``), on
PNGs whose rows use every filter type (OpenCV's own encoder at high
compression, and a numpy encoder below that cycles the five filters), and
on gray, gray+alpha, RGBA and palette images.  ``cv2.imread`` must read back
exactly what ``write_png`` wrote.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from mvxnet_makise_tpu_torch.data.image_io import read_png, write_png
from test_data import write_mini_kitti


def _encode(path, pixels, filters, color_type, palette=None):
    """A PNG of ``pixels`` (H, W, C) uint8 with row y filtered by
    ``filters[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    x = pixels.astype(np.int16)
    h, w, _ = x.shape
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]
    c = np.pad(b, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    raw = b"".join(bytes([k]) + ((x[y] - preds[k][y]) & 255).astype(
        np.uint8).tobytes() for y, k in enumerate(filters))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0,
                                      0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    body += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body)


def _smooth(rng, h=45, w=70):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 2.1 + yy * 3.3) % 256, np.sin(xx / 7) * 90 + 120,
                    (yy * 5.7) % 256], -1)
    return (img + rng.normal(0, 4, img.shape)).clip(0, 255).astype(np.uint8)


def test_mini_kitti_images_decode_as_cv2(tmp_path, rng):
    root, frames = write_mini_kitti(tmp_path, rng)
    for fid in frames:
        path = os.path.join(root, "training", "image_2", fid + ".png")
        got, want = read_png(path), cv2.imread(path)
        assert got.dtype == np.uint8 and got.shape == (370, 1224, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", [0, 1, 9])
def test_opencv_encoder_filters_decode_as_cv2(tmp_path, rng, level):
    """OpenCV picks a filter per row (Average and Paeth at levels 0 and
    9, Sub at its default)."""
    path = str(tmp_path / "img.png")
    cv2.imwrite(path, _smooth(rng), [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(read_png(path), cv2.imread(path))


@pytest.mark.parametrize("color_type,channels", [(0, 1), (4, 2), (2, 3),
                                                 (6, 4)])
@pytest.mark.parametrize("pattern", ["cycle", "runs", "paeth", "avg"])
def test_every_filter_and_colour_type_decodes_as_cv2(tmp_path, rng,
                                                     color_type, channels,
                                                     pattern):
    img = np.concatenate([_smooth(rng), _smooth(rng)], -1)[..., :channels]
    h = img.shape[0]
    filters = {"cycle": [y % 5 for y in range(h)],
               "runs": [(y // 4) % 5 for y in range(h)],
               "paeth": [4] * h, "avg": [3] * h}[pattern]
    path = str(tmp_path / "img.png")
    _encode(path, img, filters, color_type)
    np.testing.assert_array_equal(read_png(path), cv2.imread(path))


def test_palette_decodes_as_cv2(tmp_path, rng):
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, (20, 30, 1), dtype=np.uint8)
    path = str(tmp_path / "pal.png")
    _encode(path, idx, [y % 5 for y in range(20)], 3, palette)
    np.testing.assert_array_equal(read_png(path), cv2.imread(path))


def test_write_png_reads_back_in_cv2_and_read_png(tmp_path, rng):
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path), img)
    np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


def test_missing_and_unsupported_files(tmp_path, rng):
    assert read_png(str(tmp_path / "missing.png")) is None
    assert cv2.imread(str(tmp_path / "missing.png")) is None
    (tmp_path / "text.png").write_text("not an image")
    assert read_png(str(tmp_path / "text.png")) is None
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, rng.integers(0, 65535, (8, 9, 3), dtype=np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(deep)
    interlaced = str(tmp_path / "interlaced.png")
    _encode(interlaced, _smooth(rng, 4, 5), [0] * 4, 2)
    data = bytearray(open(interlaced, "rb").read())
    data[28] = 1                              # IHDR interlace byte
    crc = zlib.crc32(bytes(data[12:29]))
    data[29:33] = struct.pack(">I", crc)
    with open(interlaced, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="interlaced"):
        read_png(interlaced)
