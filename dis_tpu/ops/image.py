"""OpenCV-exact image primitives in JAX.

These reproduce the external-library semantics the reference relies on
(``/root/reference/src/main.cpp:12-50,140-155``): 3x3 Sobel (scale 1/8,
reflect-101 border), INTER_LINEAR x0.5 decimation (exact 2x2 box mean
for even dims), general INTER_LINEAR resize, and the two
``copyMakeBorder`` modes.  All ops are shape-static and jit-friendly.
"""

from __future__ import annotations

import os as _os
from typing import Tuple

import jax.numpy as jnp
from jax import lax


def reflect101_pad(img: jnp.ndarray, r: int) -> jnp.ndarray:
    return jnp.pad(img, r, mode="reflect")


def replicate_pad(img: jnp.ndarray, t: int, b: int, l: int, r: int) -> jnp.ndarray:
    return jnp.pad(img, ((t, b), (l, r)), mode="edge")


def constant_pad(img: jnp.ndarray, t: int, b: int, l: int, r: int) -> jnp.ndarray:
    return jnp.pad(img, ((t, b), (l, r)), mode="constant")


def sobel3(img: jnp.ndarray, axis: str) -> jnp.ndarray:
    """3x3 Sobel, scale 1/8, reflect-101 border (``cv::Sobel`` with
    BORDER_DEFAULT; main.cpp:19-20,34-35).  Separable [1,2,1]x[-1,0,1]."""
    p = reflect101_pad(img, 1)
    if axis == "x":
        d = p[:, 2:] - p[:, :-2]
        out = d[:-2, :] + 2.0 * d[1:-1, :] + d[2:, :]
    elif axis == "y":
        d = p[2:, :] - p[:-2, :]
        out = d[:, :-2] + 2.0 * d[:, 1:-1] + d[:, 2:]
    else:
        raise ValueError(axis)
    return out * jnp.float32(1.0 / 8.0)


def gradient_magnitude(img: jnp.ndarray) -> jnp.ndarray:
    """Sobel gradient magnitude — the reference's pyramid base image
    (Q1, main.cpp:18-26)."""
    dx = sobel3(img, "x")
    dy = sobel3(img, "y")
    return jnp.sqrt(dx * dx + dy * dy)


# Read per call (not snapshotted at import) so a measurement can toggle
# the form via os.environ between runs.
def _resize_mode() -> str:
    return _os.environ.get("DIS_TPU_RESIZE", "auto")


def resize_half(img: jnp.ndarray) -> jnp.ndarray:
    """``cv::resize(x0.5, INTER_LINEAR)`` == exact 2x2 box mean for even
    dims (main.cpp:29).

    Formulations (ulp-equivalent 2x2 means, ``DIS_TPU_RESIZE``):
    ``window`` (one 2x2/2x2 ``reduce_window``), ``window2`` (separable,
    forced association, below), ``reshape`` ([H,W] -> [H/2,2,W/2,2] +
    mean) and ``slices`` (four stride-2 slices + adds).  ``auto`` takes
    the platform's choice (dis_tpu/backend.py)."""
    h, w = img.shape
    assert h % 2 == 0 and w % 2 == 0, (
        f"resize_half requires even dims, got {h}x{w}: the pipeline "
        "always passes 2^coarsest-divisible planes (pad_divisible); "
        "odd dims would silently drop the trailing row/col in some "
        "formulations and shape-error in others")
    mode = _resize_mode()
    if mode == "auto":
        from .. import backend

        mode = backend.choices().resize
    if mode == "reshape":
        return img.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    if mode == "window":
        s = lax.reduce_window(img, jnp.float32(0), lax.add,
                              (2, 2), (2, 2), "VALID")
        return s * jnp.float32(0.25)
    if mode == "window2":
        # Separable with a FORCED association (a+c)+(b+d): an explicit
        # stride-2 row-pair add (float add semantics are fixed in HLO)
        # followed by a TWO-element reduce_window along columns (no
        # association freedom) — context-independent, unlike the
        # one-pass (2,2) window whose 4-add association XLA may re-pick
        # under vmap (batched pairs then drift 1 ulp off serial).
        s = img[0::2, :] + img[1::2, :]
        s = lax.reduce_window(s, jnp.float32(0), lax.add,
                              (1, 2), (1, 2), "VALID")
        return s * jnp.float32(0.25)
    return ((img[0::2, 0::2] + img[0::2, 1::2])
            + (img[1::2, 0::2] + img[1::2, 1::2])) * jnp.float32(0.25)


def resize_bilinear(img: jnp.ndarray, out_w: int, out_h: int) -> jnp.ndarray:
    """General ``cv::resize(..., INTER_LINEAR)`` with pixel-center
    alignment ``src = (dst + 0.5) * scale - 0.5`` and edge clamping
    (main.cpp:195). Supports [H, W] or [H, W, C]."""
    in_h, in_w = img.shape[:2]
    sx = in_w / out_w
    sy = in_h / out_h
    xs = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) * sx - 0.5
    ys = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) * sy - 0.5
    x0 = jnp.floor(xs).astype(jnp.int32)
    y0 = jnp.floor(ys).astype(jnp.int32)
    ax = jnp.where(x0 < 0, 0.0, xs - x0)
    ay = jnp.where(y0 < 0, 0.0, ys - y0)
    x0c = jnp.clip(x0, 0, in_w - 1)
    x1c = jnp.clip(x0 + 1, 0, in_w - 1)
    y0c = jnp.clip(y0, 0, in_h - 1)
    y1c = jnp.clip(y0 + 1, 0, in_h - 1)
    rows0 = jnp.take(img, y0c, axis=0)
    rows1 = jnp.take(img, y1c, axis=0)
    if img.ndim == 2:
        r00 = jnp.take(rows0, x0c, axis=1)
        r01 = jnp.take(rows0, x1c, axis=1)
        r10 = jnp.take(rows1, x0c, axis=1)
        r11 = jnp.take(rows1, x1c, axis=1)
        top = r00 * (1 - ax)[None, :] + r01 * ax[None, :]
        bot = r10 * (1 - ax)[None, :] + r11 * ax[None, :]
        return top * (1 - ay)[:, None] + bot * ay[:, None]
    else:
        r00 = jnp.take(rows0, x0c, axis=1)
        r01 = jnp.take(rows0, x1c, axis=1)
        r10 = jnp.take(rows1, x0c, axis=1)
        r11 = jnp.take(rows1, x1c, axis=1)
        top = r00 * (1 - ax)[None, :, None] + r01 * ax[None, :, None]
        bot = r10 * (1 - ax)[None, :, None] + r11 * ax[None, :, None]
        return top * (1 - ay)[:, None, None] + bot * ay[:, None, None]


def pad_divisible(img: jnp.ndarray, coarsest_scale: int) -> Tuple[jnp.ndarray, Tuple[int, int]]:
    """Replicate-pad so dims are divisible by 2**coarsest (main.cpp:140-155).
    Shape-static: padding derives from static shape."""
    h, w = img.shape
    f = 2 ** coarsest_scale
    padw = (f - w % f) % f
    padh = (f - h % f) % f
    if padw or padh:
        img = replicate_pad(img, padh // 2, padh - padh // 2,
                            padw // 2, padw - padw // 2)
    return img, (padw, padh)


def crop_padding(flow: jnp.ndarray, padw: int, padh: int, w_org: int, h_org: int) -> jnp.ndarray:
    t = padh // 2
    l = padw // 2
    return flow[t:t + h_org, l:l + w_org]
