"""KITTI optical-flow ground-truth codec (16-bit RGB PNG).

KITTI 2012/2015 store flow GT as 3-channel uint16 PNGs (devkit
``flow_read.m`` / ``flow_write.m``):

    u = (ch0 - 2**15) / 64.0
    v = (ch1 - 2**15) / 64.0
    valid = ch2 > 0         (invalid pixels are written as all-zero)

The reference repo was validated on Sintel (``.flo`` GT — the
author's commented check at ``/root/reference/src/main.cpp:123-132``);
this module adds the other major benchmark's GT format so
``--gt-dir`` / ``benchmarks/accuracy.py`` can score EPE on both the
moment real data is mounted (round-2 VERDICT item #3).

The PNG layer is utils/png.py (numpy + zlib, no OpenCV/PIL dependency
in the package).  Its reader handles every scanline filter type (real
KITTI files are OpenCV-written with adaptive filters); the writer emits
filter-0 rows.  The native reader
(tools/native_io) implements the same decode in C++; both are gated
against each other and against a cv2 oracle in tests/test_kitti.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import png

def read_png16_rgb(path: str) -> np.ndarray:
    """Decode a 16-bit truecolor (or 16-bit gray) non-interlaced PNG to
    uint16 [H, W, C]."""
    img = png.read_png(path)
    if img.dtype != np.uint16:
        raise ValueError(f"{path}: expected 16-bit PNG, got 8-bit")
    return img


def write_png16_rgb(path: str, img: np.ndarray) -> None:
    """Write uint16 [H, W, 3] as a 16-bit truecolor PNG (filter 0)."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError("write_png16_rgb expects [H, W, 3]")
    png.write_png(path, img.astype(np.uint16))


def load_kitti_flow(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read KITTI flow GT: returns (flow [H, W, 2] float32,
    valid [H, W] bool)."""
    img = read_png16_rgb(path)
    if img.shape[-1] != 3:
        raise ValueError(f"{path}: KITTI flow GT must have 3 channels")
    u = (img[..., 0].astype(np.float32) - 32768.0) / 64.0
    v = (img[..., 1].astype(np.float32) - 32768.0) / 64.0
    valid = img[..., 2] > 0
    flow = np.stack([u, v], axis=-1)
    flow[~valid] = 0.0
    return flow, valid


def save_kitti_flow(path: str, flow: np.ndarray,
                    valid: Optional[np.ndarray] = None) -> None:
    """Write flow [H, W, 2] (+ optional validity mask) in KITTI GT
    format.  Values are clamped to the format's representable range
    [-512, 511.984] px at 1/64 px quantization.

    Quantization rounds half UP (floor(q + 0.5)), following the Matlab
    devkit's flow_write rounding and our native writer.  The C++ devkit
    (io_flow.h FlowImage::write) instead TRUNCATES on its uint16 cast,
    so files it writes can differ by 1/64 px on exact-half values —
    harmless for reading GT, but note the convention if byte-comparing
    against C++-devkit-written files."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), bool)
    q = np.clip(flow * 64.0 + 32768.0, 0.0, 65535.0)
    img = np.zeros((h, w, 3), np.uint16)
    # round half UP (devkit's uint16 cast convention; matches the
    # native writer's +0.5 truncation — q is non-negative here)
    img[..., 0] = np.floor(q[..., 0] + 0.5).astype(np.uint16)
    img[..., 1] = np.floor(q[..., 1] + 0.5).astype(np.uint16)
    img[..., 2] = valid.astype(np.uint16)
    img[~valid] = 0
    write_png16_rgb(path, img)


def load_gt_any(path_base: str) -> Tuple[Optional[np.ndarray],
                                         Optional[np.ndarray]]:
    """Load ground-truth flow for a frame from whichever dataset format
    exists: ``<base>.flo`` (Middlebury/Sintel) or ``<base>.png`` (KITTI
    16-bit).  Returns (flow, valid) or (None, None) when neither file
    is present.  ``.flo`` GT has no validity channel; Sintel-style
    sentinel values (|flow| > 1e9 / NaN) are masked invalid, matching
    the reference's is_flow_correct (color_coding.cpp:8-11)."""
    import os

    flo_path = path_base + ".flo"
    png_path = path_base + ".png"
    if os.path.exists(flo_path):
        from .flo import load_flo

        flow = load_flo(flo_path)
        valid = np.isfinite(flow).all(axis=-1) & (
            np.abs(flow) < 1e9).all(axis=-1)
        return flow, valid
    if os.path.exists(png_path):
        return load_kitti_flow(png_path)
    return None, None
