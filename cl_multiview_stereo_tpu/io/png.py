"""Minimal PNG codec on numpy and the standard library's ``zlib``.

Reads 8-bit, non-interlaced grayscale, RGB and RGBA images with any of the
five scanline filter types; writes 8-bit grayscale and RGB.  Anything else
(palette or gray+alpha color types, other bit depths, Adam7 interlacing)
raises ``PngError`` naming what is unsupported.  This keeps image I/O on the
main path free of third-party imaging libraries.

The Sub and Up filters decode with vectorized numpy; Average and Paeth
carry a left-to-right dependency within each row and decode with a
per-byte loop, which is slower but only met in images written by other
encoders.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples per pixel
_COLOR_NAMES = {3: "palette", 4: "gray+alpha"}


class PngError(ValueError):
    """Malformed or unsupported PNG data."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PngError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        crc_end = pos + 12 + length
        if crc_end > len(data):
            raise PngError(f"truncated {ctype!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length : crc_end])
        if zlib.crc32(ctype + body) != crc:
            raise PngError(f"CRC mismatch in {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = crc_end
    raise PngError("missing IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(
    ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int
) -> np.ndarray:
    """Undo one scanline's filter; ``row``/``prev`` are uint8 byte rows."""
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: running sum of each byte of the pixel, modulo 256
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return row + prev
    if ftype not in (3, 4):
        raise PngError(f"unknown filter type {ftype}")
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:  # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, b, c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to an (H, W, C) uint8 array, C = 1, 3 or 4."""
    header = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError("missing IHDR chunk")
    w, h, depth, color, _compression, _filter, interlace = header
    if color not in _CHANNELS:
        name = _COLOR_NAMES.get(color, f"color type {color}")
        raise PngError(f"unsupported PNG: {name} images are not decoded")
    if depth != 8:
        raise PngError(f"unsupported PNG: bit depth {depth} (only 8 is decoded)")
    if interlace != 0:
        raise PngError("unsupported PNG: interlaced (Adam7) images are not decoded")
    bpp = _CHANNELS[color]
    stride = w * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"corrupt image data: {e}") from None
    if len(raw) != h * (stride + 1):
        raise PngError(
            f"image data holds {len(raw)} bytes, expected {h * (stride + 1)}"
        )
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out.reshape(h, w, bpp)


def encode_png(img: np.ndarray, filter_type: int = 1) -> bytes:
    """Encode an (H, W) / (H, W, 1) gray or (H, W, 3) RGB uint8 image.

    Every row uses ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth); Sub is the default because it decodes vectorized.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise PngError(f"unsupported PNG: dtype {img.dtype} (only uint8 is written)")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color, bpp = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color, bpp = 2, 3
    else:
        raise PngError(f"unsupported PNG: shape {img.shape} (gray or RGB only)")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise PngError(f"unsupported PNG: empty image {img.shape}")
    if filter_type not in range(5):
        raise PngError(f"unknown filter type {filter_type}")
    x = img.reshape(h, w * bpp).astype(np.int16)
    zeros = np.zeros_like(x)
    a = np.concatenate([zeros[:, :bpp], x[:, :-bpp]], axis=1)  # left
    b = np.concatenate([zeros[:1], x[:-1]], axis=0)  # up
    c = np.concatenate([zeros[:, :bpp], b[:, :-bpp]], axis=1)  # up-left
    if filter_type == 0:
        pred = zeros
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filtered = ((x - pred) & 0xFF).astype(np.uint8)
    scanlines = np.concatenate(
        [np.full((h, 1), filter_type, np.uint8), filtered], axis=1
    )

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body)
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (
        SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
