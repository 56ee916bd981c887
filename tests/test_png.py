"""The NumPy + zlib PNG codec behind the image I/O: round trips, every
scanline filter on decode, and agreement with PIL where installed."""

import zlib

import numpy as np
import pytest

from dis_tpu.utils import io as uio
from dis_tpu.utils import png


@pytest.mark.parametrize("shape", [(17, 23), (9, 31, 3)])
def test_round_trip_8bit(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "a.png")
    png.write_png(p, img)
    got = png.read_png(p)
    np.testing.assert_array_equal(got.reshape(img.shape), img)


def test_imwrite_imread_gray(tmp_path, monkeypatch):
    """imwrite stores BGR as RGB; imread_gray applies OpenCV's BT.601
    weights (gray replicated into RGB reads back unchanged)."""
    from dis_tpu.utils import native

    monkeypatch.setattr(native, "available", lambda: False)
    r = np.random.default_rng(1)
    gray = r.integers(0, 256, (12, 20), dtype=np.uint8)
    p = str(tmp_path / "g.png")
    uio.imwrite(p, gray)
    np.testing.assert_array_equal(uio.imread_gray(p), gray)
    uio.imwrite(p, np.repeat(gray[..., None], 3, axis=-1))
    np.testing.assert_array_equal(uio.imread_gray(p), gray)
    bgr = r.integers(0, 256, (12, 20, 3), dtype=np.uint8)
    uio.imwrite(p, bgr)
    np.testing.assert_array_equal(uio.imread_gray(p),
                                  uio.rgb_to_gray_u8(bgr[..., ::-1]))


def _png_with_filters(img):
    """Hand-built RGB PNG whose rows cycle through filter types 0-4."""
    h, w, c = img.shape
    prev = np.zeros(w * c, np.int32)
    rows = []
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        ft = y % 5
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ft == 0:
            f = cur
        elif ft == 1:
            f = cur - left
        elif ft == 2:
            f = cur - prev
        elif ft == 3:
            f = cur - (left + prev) // 2
        else:
            pred = np.array([png._paeth(a, b, cc)
                             for a, b, cc in zip(left, prev, upleft)])
            f = cur - pred
        rows.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    import struct

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (png._PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_decode_every_filter_type(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (10, 7, 3),
                                            dtype=np.uint8)
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(_png_with_filters(img))
    np.testing.assert_array_equal(png.read_png(p), img)


def test_agrees_with_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    r = np.random.default_rng(3)
    rgb = r.integers(0, 256, (15, 22, 3), dtype=np.uint8)
    p = str(tmp_path / "pil.png")
    Image.fromarray(rgb).save(p)        # PIL picks its own filters
    np.testing.assert_array_equal(png.read_png(p), rgb)
    q = str(tmp_path / "ours.png")
    png.write_png(q, rgb)
    with Image.open(q) as im:
        np.testing.assert_array_equal(np.asarray(im), rgb)
    gray = r.integers(0, 256, (15, 22), dtype=np.uint8)
    png.write_png(q, gray)
    with Image.open(q) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), gray)


def test_rejects_non_png(tmp_path):
    p = str(tmp_path / "x.png")
    with open(p, "wb") as f:
        f.write(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(p)
