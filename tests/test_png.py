"""The numpy PNG codec (io/png.py) and the image I/O built on it."""

import struct
import sys
import zlib

import numpy as np
import pytest

from cl_multiview_stereo_tpu.io import png
from cl_multiview_stereo_tpu.io.images import load_image, save_gray_png, save_png


def _rgb(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_roundtrip_each_filter(filter_type):
    img = _rgb(23, 31, seed=filter_type)
    got = png.decode_png(png.encode_png(img, filter_type))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_gray_roundtrip_each_filter(filter_type):
    img = _rgb(9, 14, seed=10 + filter_type)[..., 0]
    got = png.decode_png(png.encode_png(img, filter_type))
    assert got.shape == (9, 14, 1)
    np.testing.assert_array_equal(got[..., 0], img)


@pytest.mark.parametrize("hw", [(1, 1), (37, 53), (1, 40), (40, 1)])
def test_roundtrip_odd_shapes(hw):
    img = _rgb(*hw, seed=hw[0] * 100 + hw[1])
    for f in range(5):
        np.testing.assert_array_equal(png.decode_png(png.encode_png(img, f)), img)


def _raw_png(w, h, depth, color, rows, interlace=0):
    """A PNG with hand-built scanlines (filter byte included per row)."""

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def test_decodes_rgba_and_sub_filter_by_hand():
    # 2x1 RGBA, Sub filter: second pixel stored as the difference
    rows = bytes([1, 10, 20, 30, 255, 5, 5, 5, 0])
    got = png.decode_png(_raw_png(2, 1, 8, 6, rows))
    np.testing.assert_array_equal(
        got, np.asarray([[[10, 20, 30, 255], [15, 25, 35, 255]]], np.uint8)
    )


@pytest.mark.parametrize(
    "depth,color,interlace,match",
    [(8, 3, 0, "palette"), (8, 4, 0, "gray\\+alpha"), (16, 2, 0, "bit depth 16"),
     (8, 2, 1, "interlaced")],
)
def test_rejects_unsupported(depth, color, interlace, match):
    data = _raw_png(1, 1, depth, color, b"\x00" * 8, interlace)
    with pytest.raises(png.PngError, match=match):
        png.decode_png(data)


def test_rejects_corrupt_data():
    good = png.encode_png(_rgb(4, 4))
    with pytest.raises(png.PngError, match="signature"):
        png.decode_png(b"GIF89a" + good[6:])
    bad = bytearray(good)
    bad[40] ^= 0xFF  # inside the IDAT body
    with pytest.raises(png.PngError, match="CRC"):
        png.decode_png(bytes(bad))
    with pytest.raises(png.PngError, match="truncated|IEND"):
        png.decode_png(good[:-20])


def test_encoder_rejects_unsupported():
    with pytest.raises(png.PngError, match="dtype"):
        png.encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(png.PngError, match="shape"):
        png.encode_png(np.zeros((2, 2, 4), np.uint8))
    with pytest.raises(png.PngError, match="filter"):
        png.encode_png(np.zeros((2, 2), np.uint8), filter_type=5)


def test_image_io_without_pil(tmp_path, monkeypatch):
    """load_image / save_png / save_gray_png never import PIL for PNG; a
    JPEG without PIL fails naming the missing decoder."""
    monkeypatch.setitem(sys.modules, "PIL", None)  # any import fails
    img = _rgb(5, 7)
    save_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(load_image(str(tmp_path / "a.png")), img)
    save_gray_png(str(tmp_path / "g.png"), np.linspace(0, 1, 12).reshape(3, 4), 0.0, 1.0)
    g = load_image(str(tmp_path / "g.png"))
    assert g.shape == (3, 4, 3) and (g[..., 0] == g[..., 2]).all()
    assert g[0, 0, 0] == 0 and g[-1, -1, 0] == 255
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 16)
    with pytest.raises(ValueError, match="JPEG.*Pillow"):
        load_image(str(tmp_path / "x.jpg"))


def test_interop_with_pillow(tmp_path):
    """Pillow reads what the codec writes, and the codec reads Pillow's
    adaptively filtered output, RGBA included."""
    Image = pytest.importorskip("PIL.Image")
    img = _rgb(33, 47, seed=3)
    (tmp_path / "ours.png").write_bytes(png.encode_png(img, filter_type=4))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours.png")), img)
    # smooth content makes Pillow's adaptive filter pick Sub/Up/Avg/Paeth
    yy, xx = np.mgrid[0:33, 0:47]
    rgba = np.stack([xx * 5, yy * 7, xx + yy, 255 - xx], -1).astype(np.uint8)
    Image.fromarray(rgba).save(tmp_path / "theirs.png", optimize=True)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "theirs.png")), rgba)
    np.testing.assert_array_equal(load_image(str(tmp_path / "theirs.png")), rgba[..., :3])
