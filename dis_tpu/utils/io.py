"""Image loading with the reference's grayscale semantics.

``cv::imread(..., CV_LOAD_IMAGE_GRAYSCALE)`` (main.cpp:115-116) decodes
to BGR then converts with OpenCV's fixed-point BT.601 weights.  We
decode PNG with the native decoder (tools/native_io) or the package's
own NumPy + zlib codec (utils/png.py), with no imaging library, and
apply the same fixed-point conversion so pixel values match the
reference bit for bit on 8-bit inputs.
"""

from __future__ import annotations

import numpy as np


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """OpenCV-exact BT.601 fixed-point gray: ``(R*4899 + G*9617 +
    B*1868 + 2^13) >> 14`` (cv::cvtColor semantics used by grayscale
    imread)."""
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


def imread_gray(path: str) -> np.ndarray:
    """Load an 8-bit PNG as uint8 grayscale with OpenCV-matching
    conversion: the native C++ decoder when it is built, else
    utils/png.py.  Gray(+alpha) keeps its gray channel; RGB(A) converts
    with :func:`rgb_to_gray_u8`."""
    from . import native, png

    if native.available():
        with open(path, "rb") as f:
            out = native.png_decode_gray(f.read())
        if out is not None:
            return out
    arr = png.read_png(path)
    if arr.dtype != np.uint8:
        raise ValueError(f"{path}: expected an 8-bit image")
    if arr.shape[-1] <= 2:
        return np.ascontiguousarray(arr[..., 0])
    return rgb_to_gray_u8(arr[..., :3])


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a uint8 image as PNG: BGR [H,W,3] like the colorizer
    output (stored as RGB), or grayscale [H,W]."""
    from . import png

    out = np.asarray(img, np.uint8)
    if out.ndim == 3:
        out = out[..., ::-1]  # BGR -> RGB
    png.write_png(path, out)
