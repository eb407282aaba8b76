"""PNG decode/encode with the standard library's zlib and NumPy.

Covers what RGB-D datasets ship: 8-bit gray, gray+alpha, RGB and RGBA, and
16-bit gray depth (TUM, ICL-NUIM), non-interlaced, with all five row filter
types.  The native decoder (aslam.native) is faster when built; this module
is the decoder every installation has.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (palette images, type 3, are not supported)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth_row(row: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _average_row(row: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> [height, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum along each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average / Paeth: left-to-right recurrence
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H,W] / [H,W,C] or uint16 [H,W] / [H,W,C]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, bits, color, _, _, interlace = header
    if color not in _CHANNELS or bits not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: colour type {color}, "
                         f"{bits}-bit, interlace {interlace}")
    ch = _CHANNELS[color]
    bpp = ch * bits // 8
    pix = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if bits == 16:
        pix = pix.view(">u2").astype(np.uint16)
    shape = (height, width) if ch == 1 else (height, width, ch)
    return pix.reshape(shape)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H,W] / [H,W,C] (C in 1..4) or uint16 [H,W] -> PNG bytes
    (filter type 0 on every row)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG encode needs uint8 or uint16, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    h, w = img.shape[:2]
    bits = 8 * img.dtype.itemsize
    pix = img.astype(">u2") if bits == 16 else img
    rows = pix.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
