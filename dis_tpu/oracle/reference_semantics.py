"""Executable NumPy specification of the reference DIS semantics.

This module is the *contract* for the JAX/Pallas implementation: a
straightforward, dependency-free (NumPy-only) re-statement of what the
reference C++ computes, including its quirk ledger (SURVEY.md §2 Q1-Q10).
It is deliberately slow and simple; tests compare the JAX pipeline
against it on small inputs, and separately validate its OpenCV-exact
claims against ``cv2`` where available.

Reference citations are to ``/root/reference/src`` (file:line).
Nothing here is translated code — it is a from-scratch restatement of
the observed behavior in array form.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..config import DISConfig


# ---------------------------------------------------------------------------
# OpenCV-exact primitives (main.cpp:12-50 external-library semantics)
# ---------------------------------------------------------------------------


def reflect101_pad(img: np.ndarray, r: int) -> np.ndarray:
    """BORDER_DEFAULT = reflect-101 padding (``cv::Sobel`` default)."""
    return np.pad(img, r, mode="reflect")


def replicate_pad(img: np.ndarray, t: int, b: int, l: int, r: int) -> np.ndarray:
    """``cv::copyMakeBorder(..., BORDER_REPLICATE)`` (main.cpp:43,152)."""
    return np.pad(img, ((t, b), (l, r)), mode="edge")


def constant_pad(img: np.ndarray, t: int, b: int, l: int, r: int, v: float = 0.0) -> np.ndarray:
    """``cv::copyMakeBorder(..., BORDER_CONSTANT, 0)`` (main.cpp:45-47)."""
    return np.pad(img, ((t, b), (l, r)), mode="constant", constant_values=v)


def sobel3(img: np.ndarray, axis: str) -> np.ndarray:
    """3x3 Sobel, scale 1/8, reflect-101 border.

    Matches ``cv::Sobel(img, CV_32F, dx, dy, 3, 1/8., 0, BORDER_DEFAULT)``
    (main.cpp:19-20,34-35).  Kernel for d/dx: smooth [1,2,1] vertically,
    difference [-1,0,1] horizontally; transposed for d/dy.
    """
    img = img.astype(np.float32)
    p = reflect101_pad(img, 1)
    if axis == "x":
        d = p[:, 2:] - p[:, :-2]                      # [-1, 0, 1] horizontally
        out = d[:-2, :] + 2.0 * d[1:-1, :] + d[2:, :]  # [1, 2, 1] vertically
    elif axis == "y":
        d = p[2:, :] - p[:-2, :]
        out = d[:, :-2] + 2.0 * d[:, 1:-1] + d[:, 2:]
    else:
        raise ValueError(axis)
    return (out * np.float32(1.0 / 8.0)).astype(np.float32)


def resize_half(img: np.ndarray) -> np.ndarray:
    """``cv::resize(img, 0.5, 0.5, INTER_LINEAR)`` for float input with
    even dims (main.cpp:29): source sample at ``2*x + 0.5`` -> exact
    2x2 box average."""
    h, w = img.shape
    assert h % 2 == 0 and w % 2 == 0, "reference guarantees even dims per level"
    x = img.astype(np.float32).reshape(h // 2, 2, w // 2, 2)
    return (x.mean(axis=(1, 3))).astype(np.float32)


def resize_bilinear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """General ``cv::resize(..., INTER_LINEAR)`` for float input
    (main.cpp:195 upsample path). Pixel-center alignment:
    ``src = (dst + 0.5) * scale - 0.5``, edge-clamped."""
    img = img.astype(np.float32)
    in_h, in_w = img.shape[:2]
    sx = in_w / out_w
    sy = in_h / out_h
    xs = (np.arange(out_w, dtype=np.float64) + 0.5) * sx - 0.5
    ys = (np.arange(out_h, dtype=np.float64) + 0.5) * sy - 0.5
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    ax = (xs - x0).astype(np.float32)
    ay = (ys - y0).astype(np.float32)
    x0c = np.clip(x0, 0, in_w - 1)
    x1c = np.clip(x0 + 1, 0, in_w - 1)
    y0c = np.clip(y0, 0, in_h - 1)
    y1c = np.clip(y0 + 1, 0, in_h - 1)
    ax = np.where(x0 < 0, np.float32(0), ax)
    ay = np.where(y0 < 0, np.float32(0), ay)

    if img.ndim == 2:
        r0 = img[np.ix_(y0c, x0c)] * (1 - ax)[None, :] + img[np.ix_(y0c, x1c)] * ax[None, :]
        r1 = img[np.ix_(y1c, x0c)] * (1 - ax)[None, :] + img[np.ix_(y1c, x1c)] * ax[None, :]
        return (r0 * (1 - ay)[:, None] + r1 * ay[:, None]).astype(np.float32)
    else:
        r0 = img[np.ix_(y0c, x0c)] * (1 - ax)[None, :, None] + img[np.ix_(y0c, x1c)] * ax[None, :, None]
        r1 = img[np.ix_(y1c, x0c)] * (1 - ax)[None, :, None] + img[np.ix_(y1c, x1c)] * ax[None, :, None]
        return (r0 * (1 - ay)[:, None, None] + r1 * ay[:, None, None]).astype(np.float32)


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv::imread(..., GRAYSCALE)`` uint8 conversion (main.cpp:115):
    fixed-point ``(R*4899 + G*9617 + B*1868 + 2^13) >> 14`` on BGR input."""
    b = img[..., 0].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    r = img[..., 2].astype(np.int64)
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


# ---------------------------------------------------------------------------
# Divisibility padding (main.cpp:140-155) and crop (main.cpp:198)
# ---------------------------------------------------------------------------


def pad_divisible(img: np.ndarray, coarsest_scale: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Replicate-pad so W,H are divisible by 2**coarsest_scale; returns
    (padded, (padw, padh)). Split floor/ceil between the two sides."""
    h, w = img.shape
    f = 2 ** coarsest_scale
    padw = (f - w % f) % f
    padh = (f - h % f) % f
    if padw or padh:
        img = replicate_pad(
            img,
            padh // 2, padh - padh // 2,
            padw // 2, padw - padw // 2,
        )
    return img, (padw, padh)


def crop_padding(flow: np.ndarray, padw: int, padh: int, w_org: int, h_org: int) -> np.ndarray:
    """Remove the divisibility padding (main.cpp:198)."""
    t = padh // 2
    l = padw // 2
    return flow[t:t + h_org, l:l + w_org]


# ---------------------------------------------------------------------------
# Pyramid (main.cpp:12-50) — Q1: level 0 is the Sobel gradient MAGNITUDE
# ---------------------------------------------------------------------------


def construct_pyramid(
    img: np.ndarray, coarsest_scale: int, img_padding: int
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Build padded (image, dx, dy) pyramids.

    Level 0 = Sobel gradient magnitude of the input (Q1, main.cpp:18-26);
    level i = 0.5x INTER_LINEAR resize of level i-1 (main.cpp:29).
    Per level: 3x3 Sobel dx/dy of the magnitude image (main.cpp:34-35),
    then pad each level by ``img_padding``: image replicate, gradients
    zero (main.cpp:41-49).
    """
    img = img.astype(np.float32)
    levels, dxs, dys = [], [], []
    cur = None
    for i in range(coarsest_scale + 1):
        if i == 0:
            dx = sobel3(img, "x")
            dy = sobel3(img, "y")
            cur = np.sqrt(dx * dx + dy * dy).astype(np.float32)
        else:
            cur = resize_half(cur)
        levels.append(cur)
        dxs.append(sobel3(cur, "x"))
        dys.append(sobel3(cur, "y"))
    p = img_padding
    out_img = [replicate_pad(l, p, p, p, p) for l in levels]
    out_dx = [constant_pad(d, p, p, p, p) for d in dxs]
    out_dy = [constant_pad(d, p, p, p, p) for d in dys]
    return out_img, out_dx, out_dy


# ---------------------------------------------------------------------------
# Patch grid geometry (patch_grid.cpp:17-51)
# ---------------------------------------------------------------------------


def grid_centers(width: int, height: int, steps: int) -> np.ndarray:
    """Patch-center coordinates [N, 2] as float (x, y), in the reference's
    x-outer / y-inner order (patch_grid.cpp:39-49)."""
    npw = int(math.ceil(width / steps))
    nph = int(math.ceil(height / steps))
    offw = int(math.floor((width - (npw - 1) * steps) / 2))
    offh = int(math.floor((height - (nph - 1) * steps) / 2))
    xs = np.arange(npw) * steps + offw
    ys = np.arange(nph) * steps + offh
    cx, cy = np.meshgrid(xs, ys, indexing="ij")  # x-outer
    return np.stack([cx.ravel(), cy.ravel()], axis=-1).astype(np.float32)


def grid_shape(width: int, height: int, steps: int) -> Tuple[int, int]:
    return int(math.ceil(width / steps)), int(math.ceil(height / steps))


# ---------------------------------------------------------------------------
# Patch template extraction + Hessian (patch.cpp:47-91)
# ---------------------------------------------------------------------------


def extract_templates(
    img: np.ndarray, dx: np.ndarray, dy: np.ndarray,
    centers: np.ndarray, ps: int, pad: int, tmp_w: int,
):
    """Extract T, Tdx, Tdy ([N, ps*ps]) at rounded centers (patch.cpp:47-73)."""
    n = centers.shape[0]
    lb = -(ps // 2)
    offs = np.arange(lb, ps // 2)  # lb..ub inclusive
    px = np.rint(centers[:, 0]).astype(np.int64) + pad
    py = np.rint(centers[:, 1]).astype(np.int64) + pad
    cols = px[:, None, None] + offs[None, None, :]
    rows = py[:, None, None] + offs[None, :, None]
    flat = img.ravel()
    idx = rows * tmp_w + cols
    T = flat[idx].reshape(n, -1).astype(np.float32)
    Tdx = dx.ravel()[idx].reshape(n, -1).astype(np.float32)
    Tdy = dy.ravel()[idx].reshape(n, -1).astype(np.float32)
    return T, Tdx, Tdy


def hessians(Tdx: np.ndarray, Tdy: np.ndarray) -> np.ndarray:
    """2x2 Gauss-Newton Hessians [N, 2, 2] with the det==0 guard
    (patch.cpp:75-91)."""
    a = (Tdx * Tdx).sum(axis=1)
    b = (Tdx * Tdy).sum(axis=1)
    c = (Tdy * Tdy).sum(axis=1)
    det = a * c - b * b
    guard = (det == 0).astype(np.float32) * np.float32(1e-10)
    a = a + guard
    c = c + guard
    H = np.stack([np.stack([a, b], -1), np.stack([b, c], -1)], -2)
    return H.astype(np.float32)


def solve2x2(H: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """Closed-form 2x2 solve (Eigen ``hessian.lu().solve`` patch.cpp:176)."""
    a = H[..., 0, 0]; b = H[..., 0, 1]; c = H[..., 1, 0]; d = H[..., 1, 1]
    det = a * d - b * c
    x = (d * rhs[..., 0] - b * rhs[..., 1]) / det
    y = (-c * rhs[..., 0] + a * rhs[..., 1]) / det
    return np.stack([x, y], axis=-1)


# ---------------------------------------------------------------------------
# Bilinear query-patch sampling (patch.cpp:207-267, Q10 ceil variant)
# ---------------------------------------------------------------------------


def sample_patches(
    img2: np.ndarray, pos: np.ndarray, ps: int, pad: int, tmp_w: int,
    normalize: bool,
) -> np.ndarray:
    """Warped query patches [N, ps*ps] at float positions ``pos`` [N,2].

    Mirrors patch.cpp:207-267: weights from floor fractions, 4-tap taps
    addressed from ``pos_i = ceil(pos + 1e-5)`` (Q10), optional
    mean-subtraction (patch.cpp:264-266).
    """
    n = pos.shape[0]
    half = ps // 2
    l = np.floor(pos[:, 0]).astype(np.float32)
    k = np.floor(pos[:, 1]).astype(np.float32)
    a = (pos[:, 0] - l).astype(np.float32)
    b = (pos[:, 1] - k).astype(np.float32)
    w0 = (1 - a) * (1 - b)
    w1 = a * (1 - b)
    w2 = b * (1 - a)
    w3 = a * b

    cpx = np.ceil(pos[:, 0] + np.float32(1e-5)).astype(np.int64) + pad
    cpy = np.ceil(pos[:, 1] + np.float32(1e-5)).astype(np.int64) + pad
    # 9x9 window with base (cpy - half - 1, cpx - half - 1)
    doff = np.arange(ps + 1)
    rows = (cpy - half - 1)[:, None, None] + doff[None, :, None]
    cols = (cpx - half - 1)[:, None, None] + doff[None, None, :]
    tmp_h = img2.shape[0]
    rows = np.clip(rows, 0, tmp_h - 1)
    cols = np.clip(cols, 0, tmp_w - 1)
    W = img2[rows, cols]  # [N, ps+1, ps+1]

    q = (
        w3[:, None, None] * W[:, 1:, 1:]
        + w2[:, None, None] * W[:, 1:, :-1]
        + w1[:, None, None] * W[:, :-1, 1:]
        + w0[:, None, None] * W[:, :-1, :-1]
    ).reshape(n, ps * ps).astype(np.float32)
    if normalize:
        q = q - q.sum(axis=1, keepdims=True) / np.float32(ps * ps)
    return q


# ---------------------------------------------------------------------------
# Batched-but-faithful IC-LK per scale (patch.cpp:119-203)
# ---------------------------------------------------------------------------


def inverse_search_scale(
    img2: np.ndarray, T: np.ndarray, Tdx: np.ndarray, Tdy: np.ndarray,
    H: np.ndarray, centers: np.ndarray, init_u: np.ndarray,
    cfg: DISConfig, width: int, height: int,
) -> np.ndarray:
    """Run the per-patch IC-LK search for one scale; returns final u [N,2].

    Faithful to the reference loop semantics:
    - start: ``u = init``; OOB start => converged immediately with
      ``patch_second = T`` (patch.cpp:131-138).
    - loop: delta from ``H^-1 [sum(Tdx*Q); sum(Tdy*Q)]`` (Q3: the template
      is never subtracted), ``u -= delta``, outlier/bounds policing resets
      ``u`` to init and freezes (Q9), resample, stop after
      ``iterations+1`` body executions (Q5: no residual test).
    """
    ps = cfg.patch_size
    pad = cfg.img_padding
    tmp_w = width + 2 * pad
    lb = np.float32(-float(ps) / 2.0)
    ub_w = np.float32(width + ps // 2 - 2)
    ub_h = np.float32(height + ps // 2 - 2)
    thresh = np.float32(cfg.outlier_thresh)

    fixed = cfg.mode == "fixed"
    Tn = T
    if fixed and cfg.patch_normalization:
        Tn = T - T.sum(axis=1, keepdims=True) / np.float32(ps * ps)

    def oob(p):
        return (p[:, 0] < lb) | (p[:, 1] < lb) | (p[:, 0] > ub_w) | (p[:, 1] > ub_h)

    u = init_u.astype(np.float32).copy()
    pos = centers + u
    start = pos.copy()
    converged = oob(pos)
    Q = np.where(
        converged[:, None], T,
        sample_patches(img2, pos, ps, pad, tmp_w, cfg.patch_normalization),
    ).astype(np.float32)

    for it in range(1, cfg.iterations + 2):  # counter_iter 1..iterations+1
        active = ~converged
        if not active.any():
            break
        R = Q - Tn if fixed else Q
        rhs = np.stack([(Tdx * R).sum(axis=1), (Tdy * R).sum(axis=1)], axis=-1)
        delta = solve2x2(H, rhs)
        u_new = u - delta
        p_new = centers + u_new
        policed = (np.linalg.norm(start - p_new, axis=1) > thresh) | oob(p_new)
        u_next = np.where(policed[:, None], init_u, u_new)
        u = np.where(active[:, None], u_next, u)
        pos = centers + u
        Qs = sample_patches(img2, pos, ps, pad, tmp_w, cfg.patch_normalization)
        Q = np.where(active[:, None], Qs, Q)
        newly_done = active & policed
        if fixed:
            small = np.linalg.norm(delta, axis=1) < cfg.conv_eps
            newly_done = newly_done | (active & small)
        converged = converged | newly_done
        if it > cfg.iterations:
            break
    return u


# ---------------------------------------------------------------------------
# Densification (patch_grid.cpp:121-182, Q2-intent zeroed weights, Q6/Q7)
# ---------------------------------------------------------------------------


def densify(
    u: np.ndarray, centers: np.ndarray, width: int, height: int, ps: int,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Scatter-add patch flows into a dense [H, W, 2] field.

    Uniform weight 0.5 per contribution (Q6) unless per-patch ``weights``
    given (fixed mode: 1/max(1, ||r||^2) per the DIS paper); all patches
    valid (Q7); weight buffer zero-initialized (Q2 intent).
    """
    half = ps // 2
    flow = np.zeros((height, width, 2), dtype=np.float32)
    wsum = np.zeros((height, width), dtype=np.float32)
    if weights is None:
        weights = np.full(u.shape[0], 0.5, dtype=np.float32)
    cx = np.rint(centers[:, 0]).astype(np.int64)
    cy = np.rint(centers[:, 1]).astype(np.int64)
    for n in range(u.shape[0]):
        x0 = max(cx[n] - half, 0)
        x1 = min(cx[n] + half, width)   # ub inclusive = c+half-1
        y0 = max(cy[n] - half, 0)
        y1 = min(cy[n] + half, height)
        if x0 >= x1 or y0 >= y1:
            continue
        flow[y0:y1, x0:x1] += u[n] * weights[n]
        wsum[y0:y1, x0:x1] += weights[n]
    nz = wsum > 0
    flow[nz] /= wsum[nz][:, None]
    return flow


# ---------------------------------------------------------------------------
# Coarse-to-fine orchestrator (optical_flow.cpp:19-132)
# ---------------------------------------------------------------------------


def dis_flow_oracle(img1: np.ndarray, img2: np.ndarray, cfg: DISConfig) -> np.ndarray:
    """Full DIS pipeline on a pre-padded grayscale float pair.

    ``img1``/``img2`` must already be divisibility-padded
    (``pad_divisible``); returns flow [H/2**finest, W/2**finest, 2]
    (the caller applies the finest!=0 upscale and the padding crop, as
    main.cpp:191-198 does).
    """
    h, w = img1.shape
    assert img1.shape == img2.shape
    f = 2 ** cfg.coarsest_scale
    assert w % f == 0 and h % f == 0, "inputs must be divisibility-padded"

    p1, dx1, dy1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding)
    p2, dx2, dy2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding)

    flow_prev = None
    out = None
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        sw, sh = cfg.scale_dims(w, h, scale)
        tmp_w = sw + 2 * cfg.img_padding
        centers = grid_centers(sw, sh, cfg.steps)
        T, Tdx, Tdy = extract_templates(
            p1[scale], dx1[scale], dy1[scale], centers, cfg.patch_size,
            cfg.img_padding, tmp_w,
        )
        H = hessians(Tdx, Tdy)
        if flow_prev is None:
            init_u = np.zeros_like(centers)
        else:
            # NN lookup into coarser flow, x2 (patch_grid.cpp:108-119, Q8)
            cx = np.floor(centers[:, 0] / 2).astype(np.int64)
            cy = np.floor(centers[:, 1] / 2).astype(np.int64)
            init_u = flow_prev[cy, cx] * np.float32(2.0)
        u = inverse_search_scale(
            p2[scale], T, Tdx, Tdy, H, centers, init_u, cfg, sw, sh,
        )
        if cfg.mode == "fixed":
            # residual-adaptive densification weight (DIS paper eq. 4)
            pad = cfg.img_padding
            Qf = sample_patches(p2[scale], centers + u, cfg.patch_size, pad,
                                tmp_w, cfg.patch_normalization)
            Tn = T - T.sum(axis=1, keepdims=True) / np.float32(cfg.num_points_patch) \
                if cfg.patch_normalization else T
            r2 = ((Qf - Tn) ** 2).sum(axis=1)
            wts = 1.0 / np.maximum(1.0, r2)
            # Patches frozen at start (OOB init) never resampled; their
            # residual is undefined, so they get constant weight 1.0
            # (matches models/dis.py::_fixed_weights).
            ps2f = np.float32(-float(cfg.patch_size) / 2.0)
            ubw = np.float32(sw + cfg.patch_size // 2 - 2)
            ubh = np.float32(sh + cfg.patch_size // 2 - 2)
            p0 = centers + init_u
            start_oob = ((p0[:, 0] < ps2f) | (p0[:, 1] < ps2f)
                         | (p0[:, 0] > ubw) | (p0[:, 1] > ubh))
            wts = np.where(start_oob, np.float32(1.0), wts)
        else:
            wts = None
        dense = densify(u, centers, sw, sh, cfg.patch_size, wts)
        flow_prev = dense
        out = dense
    return out
