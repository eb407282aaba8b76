"""Stdlib-zlib PNG codec (aslam.utils.png): round trips, all five row
filters against an independent encoder, and rejection of bad input."""

import struct
import zlib

import numpy as np
import pytest

from aslam.utils import png

KINDS = {
    "gray8": ((13, 17), np.uint8),
    "gray_alpha8": ((9, 11, 2), np.uint8),
    "rgb8": ((12, 7, 3), np.uint8),
    "rgba8": ((5, 6, 4), np.uint8),
    "depth16": ((10, 19), np.uint16),
}


def _image(kind, seed=0):
    shape, dtype = KINDS[kind]
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype,
                        endpoint=True)


def _filter_line(ftype, line, prev, bpp):
    """PNG row filter (spec section 9.2), straight from its definition."""
    x = line.astype(np.int64)
    b = prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) % 256).astype(np.uint8)


def _encode_filtered(img, ftypes):
    """Encode with the given filter types cycled over the rows."""
    ch = 1 if img.ndim == 2 else img.shape[2]
    bits = 8 * img.dtype.itemsize
    bpp = ch * bits // 8
    h, w = img.shape[:2]
    rows = (img.astype(">u2") if bits == 16 else img).reshape(h, -1)
    rows = rows.view(np.uint8)
    prev = np.zeros(rows.shape[1], np.uint8)
    raw = b""
    for y in range(h):
        f = ftypes[y % len(ftypes)]
        raw += bytes([f]) + _filter_line(f, rows[y], prev, bpp).tobytes()
        prev = rows[y]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    ihdr = struct.pack(">IIBBBBB", w, h, bits, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_round_trip(kind, tmp_path):
    img = _image(kind)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    out = png.read_png(path)
    assert out.dtype == img.dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "depth16"])
def test_decode_each_filter(kind, ftype):
    img = _image(kind, seed=ftype)
    np.testing.assert_array_equal(
        png.decode_png(_encode_filtered(img, [ftype])), img)


def test_decode_mixed_filters():
    img = _image("rgba8", seed=7)
    np.testing.assert_array_equal(
        png.decode_png(_encode_filtered(img, [4, 3, 1, 0, 2])), img)


def test_rejects_bad_input():
    data = png.encode_png(_image("gray8"))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + data[6:])
    bad = bytearray(data)
    bad[40] ^= 0xFF                       # inside the IDAT body
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad))
    palette = struct.pack(">IIBBBBB", 4, 4, 8, 3, 0, 0, 0)
    with pytest.raises(ValueError, match="unsupported"):
        png.decode_png(b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", palette)
                       + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.encode_png(np.zeros((2, 2), np.float32))
