"""PNG codec in NumPy and the standard library's ``zlib``.

Reads non-interlaced, paletteless PNGs of 8 or 16 bits per sample (gray,
gray+alpha, RGB, RGBA) with every scanline filter type; writes 8-bit
gray or RGB and 16-bit RGB with filter-0 rows.  It is the fallback the
package's image I/O and KITTI ground-truth codec share, so the main
path needs no imaging library; the native decoder (utils/native.py)
stays first in line where it is built.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}       # color type -> samples/pixel
# Upper bound on the pixel count accepted from an untrusted IHDR before
# any dims-sized allocation.
_MAX_PIXELS = 100_000_000


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa = abs(p - a)
    pb = abs(p - b)
    pc = abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filtering.  ``raw`` is the decompressed stream
    ([h * (1 + stride)] bytes); returns [h, stride] uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = raw[pos + 1:pos + 1 + stride].copy()
        pos += 1 + stride
        if ftype == 0:
            rec = row
        elif ftype == 1:   # Sub: recon[i] = row[i] + recon[i - bpp]
            rec = row
            # prefix dependency along each byte lane modulo bpp:
            # cumulative sum with uint8 wraparound == mod-256 arithmetic
            for lane in range(bpp):
                rec[lane::bpp] = np.cumsum(rec[lane::bpp],
                                           dtype=np.uint32).astype(np.uint8)
        elif ftype == 2:   # Up
            rec = (row.astype(np.uint16) + prev).astype(np.uint8)
        elif ftype == 3:   # Average
            rec = row
            left = np.zeros(bpp, np.uint16)
            for i in range(0, stride, bpp):
                seg = ((rec[i:i + bpp].astype(np.uint16)
                        + ((left + prev[i:i + bpp]) >> 1)) & 0xFF)
                rec[i:i + bpp] = seg.astype(np.uint8)
                left = seg
        elif ftype == 4:   # Paeth (sequential left dependency)
            rec = row.astype(np.int32)
            pr = prev.astype(np.int32)
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = pr[i]
                c = pr[i - bpp] if i >= bpp else 0
                rec[i] = (rec[i] + _paeth(a, b, c)) & 0xFF
            rec = rec.astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter type {ftype}")
        out[y] = rec
        prev = rec
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to [H, W, C] uint8 (8-bit) or uint16 (16-bit)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    width = height = depth = ctype = None
    idat = []
    while pos + 8 <= len(buf):
        length, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, depth, ctype, comp, filt, ilace = struct.unpack(
                ">IIBBBBB", data)
            if ilace:
                raise ValueError(f"{path}: interlaced PNG unsupported")
            if comp or filt:
                raise ValueError(f"{path}: nonstandard compression/filter")
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: missing IHDR")
    if not (0 < width and 0 < height and width * height <= _MAX_PIXELS):
        raise ValueError(f"{path}: implausible PNG dims {width}x{height}")
    channels = _CHANNELS.get(ctype)
    if channels is None:
        raise ValueError(f"{path}: unsupported PNG color type {ctype}")
    if depth not in (8, 16):
        raise ValueError(f"{path}: unsupported bit depth {depth}")
    nbytes = depth // 8
    bpp = channels * nbytes
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + stride):
        raise ValueError(f"{path}: PNG payload size mismatch")
    rows = _unfilter(raw, height, stride, bpp)
    if depth == 8:
        return rows.reshape(height, width, channels)
    # 16-bit PNG samples are big-endian
    be = rows.reshape(height, width, channels, 2).astype(np.uint16)
    return be[..., 0] * 256 + be[..., 1]


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W] (gray) or [H, W, 3] (RGB), or uint16
    [H, W, 3], as a non-interlaced PNG with filter-0 rows."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth = 0, 8
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[-1] == 3:
        ctype, depth = 2, 8
    elif img.dtype == np.uint16 and img.ndim == 3 and img.shape[-1] == 3:
        ctype, depth = 2, 16
    else:
        raise ValueError(f"cannot write {img.dtype} {img.shape} as PNG")
    h, w = img.shape[:2]
    data = img.astype(">u2" if depth == 16 else np.uint8).tobytes()
    stride = len(data) // h
    rows = b"".join(
        b"\x00" + data[y * stride:(y + 1) * stride] for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(rows, 6)))
        f.write(chunk(b"IEND", b""))
