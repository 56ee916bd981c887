"""Densification: patch displacements -> dense flow field.

The reference scatter-adds each patch's ``u`` (weight 0.5) over its
ps x ps footprint, then normalizes by the accumulated weight
(patch_grid.cpp:121-182; quirks Q2-intent/Q6/Q7).  Instead of a
scatter, this is reformulated as a *transposed convolution*: the
per-patch values live on the regular patch grid, and a
``conv_general_dilated`` with lhs_dilation == patch stride and a
ps x ps all-ones kernel places every patch's contribution over its
footprint in one fused XLA op.  Footprint clipping at image borders
falls out of the convolution padding; the weight plane is the same conv
applied to the per-patch weights.
"""

from __future__ import annotations

import functools as _functools
import os
from typing import Optional

import numpy as np
import jax.numpy as jnp
from jax import lax

from .grid import GridGeometry

# Densification algorithm selection (all variants are bit-compatible up
# to fp reassociation and tested against each other):
#   dilated  — one depthwise conv_general_dilated
#   batch    — same conv but channels as batch dim, C_in=1
#   phases   — s^2 phase decomposition: each output phase (y%s, x%s) is
#              a plain small-window sum over the patch grid (shifted
#              adds), then interleaved (the default; at stride 2 the
#              dilated conv does ~s^2 more work)
_ALGO = os.environ.get("DIS_TPU_DENSIFY", "phases")
# Phase-interleave assembly (all bitwise equal): "twostep" (the default:
# both phase merges on the second-minor dim, two transposes, no
# arithmetic), "stack" (one stack + reshape), "rowconv" (per-phase 1-D
# dilated row convs) and "conv" (one-hot transposed conv).  An isolated
# win that breaks XLA's fusion of the phase sums into their neighbors
# can lose end to end.
_ASSEMBLE = os.environ.get("DIS_TPU_ASSEMBLE", "twostep")


def densify(u: jnp.ndarray, geom: GridGeometry, width: int, height: int,
            ps: int, weights: Optional[jnp.ndarray] = None,
            out_row0: int = 0) -> jnp.ndarray:
    """Dense flow [height, width, 2] from per-patch ``u`` [N, 2].

    ``weights`` is an optional per-patch densification weight [N]
    (fixed mode: ``1/max(1, ||r||^2)``); None means the reference's
    uniform weight (Q6), for which the result reduces to the mean of
    overlapping patch flows.

    For row-ranged grids (exact tiling) the output window starts at
    global row ``out_row0`` and spans ``height`` rows; the caller must
    include every patch row whose footprint intersects the window.

    """
    return _densify_impl(u, geom, width, height, ps, weights, out_row0)


def _densify_impl(u: jnp.ndarray, geom: GridGeometry, width: int, height: int,
                  ps: int, weights: Optional[jnp.ndarray],
                  out_row0: int) -> jnp.ndarray:
    # Patch values on the [num_h, num_w] grid. u is x-outer/y-inner
    # (index = ix * num_h + iy), so reshape to [num_w, num_h] then swap.
    ug = u.reshape(geom.num_w, geom.num_h, 2).transpose(1, 0, 2)
    tconv = _tconv_fn(geom, width, height, ps, out_row0)
    if weights is None:
        # Uniform weights (Q6): the weight plane is a COMPILE-TIME
        # constant — per-pixel patch coverage counts, small integers
        # that are exact in f32 under ANY summation order, so the
        # precomputed plane is bitwise what the device conv produces.
        # Saves the whole weight-plane stencil + its interleave.
        vg = ug
        wsum = jnp.asarray(_uniform_wsum(
            (geom.num_w, geom.num_h, geom.offset_w, geom.offset_h,
             geom.steps, geom.iy0), width, height, ps, out_row0))
    else:
        wg = weights.reshape(geom.num_w, geom.num_h).T[..., None]
        vg = ug * wg
        wsum = tconv(wg, 1)

    fsum = tconv(vg, 2)
    return jnp.where(wsum > 0, fsum / jnp.where(wsum > 0, wsum, 1.0), 0.0)


@_functools.lru_cache(maxsize=64)
def _uniform_wsum(geom_key, width: int, height: int, ps: int,
                  out_row0: int) -> np.ndarray:
    """[height, width, 1] float32 patch-coverage counts for a uniform-
    weight grid (NumPy, cached per static geometry)."""
    num_w, num_h, off_w, off_h, s, iy0 = geom_key
    half = ps // 2
    cnt = np.zeros((height, width), np.float32)
    ys = (np.arange(iy0, iy0 + num_h) * s + off_h) - out_row0
    xs = np.arange(num_w) * s + off_w
    # 1-D coverage profiles (the footprint is separable).  hi clamps to
    # lo so patches entirely outside the window contribute zero (a
    # negative hi would wrap the Python slice) — the pipeline's window
    # plans never over-include rows, but keep the function total.
    cov_y = np.zeros(height, np.float32)
    for cy in ys:
        lo = max(0, cy - half)
        hi = max(lo, min(height, cy + half))
        cov_y[lo:hi] += 1.0
    cov_x = np.zeros(width, np.float32)
    for cx in xs:
        lo = max(0, cx - half)
        hi = max(lo, min(width, cx + half))
        cov_x[lo:hi] += 1.0
    cnt = np.outer(cov_y, cov_x)
    return cnt[..., None].astype(np.float32)


def _tconv_fn(geom: GridGeometry, width: int, height: int, ps: int,
              out_row0: int):
    """Selected transposed-conv stencil (x [nh, nw, c] -> [H, W, c]) for
    the given grid geometry; channels are generic, so the batched rule
    folds pairs into them."""
    half = ps // 2
    s = geom.steps
    # A patch at grid index i covers pixels x with
    #   x - (i*s + off) in [-ps/2, ps/2 - 1].
    # The correlation with lhs_dilation=s computes
    #   y[x] = sum_i v[i] * 1[x - i*s in [pad_lo - ps + 1, pad_lo]]
    # so pad_lo = off + ps/2 - 1 aligns the footprint, and pad_hi is
    # chosen to make the output exactly [height, width].  For a
    # row-ranged grid the effective y offset folds in the grid's first
    # patch row and the output window start.
    eff_off_h = geom.iy0 * s + geom.offset_h - out_row0
    pad_lo_x = geom.offset_w + half - 1
    pad_lo_y = eff_off_h + half - 1
    dil_w = (geom.num_w - 1) * s + 1
    dil_h = (geom.num_h - 1) * s + 1
    pad_hi_x = width - 1 + (ps - 1) - pad_lo_x - (dil_w - 1)
    pad_hi_y = height - 1 + (ps - 1) - pad_lo_y - (dil_h - 1)

    def tconv_dilated(x, c):
        # One fused 2-D dilated conv.
        lhs = x.transpose(2, 0, 1)[None]   # [1, c, num_h, num_w]
        ker = jnp.ones((c, 1, ps, ps), jnp.float32)  # depthwise ones
        out = lax.conv_general_dilated(
            lhs, ker,
            window_strides=(1, 1),
            padding=((pad_lo_y, pad_hi_y), (pad_lo_x, pad_hi_x)),
            lhs_dilation=(s, s),
            rhs_dilation=(1, 1),
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            feature_group_count=c,
            precision=lax.Precision.HIGHEST,
        )
        return out[0].transpose(1, 2, 0)  # [height, width, c]

    def tconv_batch(x, c):
        # Same dilated conv, but channels ride the BATCH dim with
        # C_in=1 (a plain conv instead of a depthwise one).
        lhs = x.transpose(2, 0, 1)[:, None]  # [c, 1, num_h, num_w]
        ker = jnp.ones((1, 1, ps, ps), jnp.float32)
        out = lax.conv_general_dilated(
            lhs, ker,
            window_strides=(1, 1),
            padding=((pad_lo_y, pad_hi_y), (pad_lo_x, pad_hi_x)),
            lhs_dilation=(s, s),
            rhs_dilation=(1, 1),
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=lax.Precision.HIGHEST,
        )
        return out[:, 0].transpose(1, 2, 0)

    def tconv_phases(x, c):
        # Phase decomposition: for output row y = i*s + p the set of
        # contributing grid rows is i + [lo_p, hi_p] with
        #   lo_p = ceil((p - pad_lo)/s), hi_p = floor((p - pad_lo + ps-1)/s)
        # (derived from the dilated-conv support condition
        #  gy*s in [y - pad_lo, y - pad_lo + ps - 1]); each phase is a
        # tiny static-window sum over the grid (shifted adds, no
        # dilated intermediates), assembled with interior-dilated
        # lax.pad.  Row sums are shared across column phases.
        # Generous zero-pad so every phase window slices in-bounds even
        # for stripe-mode grids where pad_lo can reach -(ps + half).
        P = 4 * ps
        gh, gw = x.shape[:2]
        xpad = jnp.pad(x, ((P, P), (P, P), (0, 0)))

        def wnd(p, pad_lo):
            return (-(-(p - pad_lo) // s), (p - pad_lo + ps - 1) // s)

        n_i = [-(-(height - p) // s) for p in range(s)]
        n_j = [-(-(width - q) // s) for q in range(s)]

        rowsums = []
        for p in range(s):
            lo, hi = wnd(p, pad_lo_y)
            acc = None
            for d in range(lo, hi + 1):
                sl = lax.slice_in_dim(xpad, P + d, P + d + n_i[p], axis=0)
                acc = sl if acc is None else acc + sl
            rowsums.append(acc if acc is not None
                           else jnp.zeros((n_i[p], gw + 2 * P, c), x.dtype))

        # Interleave the s^2 phases with ONE stack + reshape instead of
        # s^2 interior-dilated pad passes: pad every phase to a
        # common [n_max_i, n_max_j], stack as [n_i, s, n_j, s, c]
        # (y = i*s + p, x = j*s + q in row-major order), reshape, crop.
        ni_max = max(n_i)
        nj_max = max(n_j)
        cols = []
        for p in range(s):
            rs = rowsums[p]
            row_phases = []
            for q in range(s):
                lo, hi = wnd(q, pad_lo_x)
                acc = None
                for e in range(lo, hi + 1):
                    sl = lax.slice_in_dim(rs, P + e, P + e + nj_max, axis=1)
                    acc = sl if acc is None else acc + sl
                if acc is None:
                    acc = jnp.zeros((rs.shape[0], nj_max, c), x.dtype)
                row_phases.append(acc)
            ph = jnp.stack(row_phases, axis=2)        # [n_i[p], nj_max, s, c]
            if rs.shape[0] < ni_max:
                ph = jnp.pad(ph, ((0, ni_max - rs.shape[0]), (0, 0), (0, 0),
                                  (0, 0)))
            cols.append(ph)
        if _ASSEMBLE == "twostep":
            # Two-step interleave that keeps BOTH phase merges off the
            # minor dim (the stack assembly's [ni, s, nj, s, c] puts the
            # column phase q, size s, on it): interleave rows, transpose,
            # interleave columns, transpose back.  Pure data movement —
            # no float arithmetic — hence bitwise equal to the stack
            # assembly (tests/test_densify_variants.py).  Channels ride
            # the LEADING dim; the final [c, H, W] -> [H, W, c]
            # transpose is layout-only.
            ys = []
            for q in range(s):
                lo, hi = wnd(q, pad_lo_x)
                planes = []
                for p in range(s):
                    rs = rowsums[p]                      # [n_i[p], gw2P, c]
                    acc = None
                    for e in range(lo, hi + 1):
                        sl = lax.slice_in_dim(rs, P + e, P + e + nj_max,
                                              axis=1)
                        acc = sl if acc is None else acc + sl
                    if acc is None:
                        acc = jnp.zeros((rs.shape[0], nj_max, c), x.dtype)
                    if acc.shape[0] < ni_max:
                        acc = jnp.pad(acc, ((0, ni_max - acc.shape[0]),
                                            (0, 0), (0, 0)))
                    planes.append(acc.transpose(2, 0, 1))  # [c, ni, nj]
                yq = jnp.stack(planes, axis=2)           # [c, ni, s(p), nj]
                yq = yq.reshape(c, ni_max * s, nj_max)   # rows interleaved
                ys.append(yq.transpose(0, 2, 1))         # [c, nj, H']
            full = jnp.stack(ys, axis=2)                 # [c, nj, s(q), H']
            full = full.reshape(c, nj_max * s, ni_max * s)  # cols interleaved
            full = full.transpose(0, 2, 1)               # [c, H', W']
            return full[:, :height, :width].transpose(1, 2, 0)
        if _ASSEMBLE == "rowconv":
            # Row phases only: each phase's COLUMN pass runs as a 1-D
            # lane-dilated conv producing full-width output rows, so the
            # only interleave left is the row merge [ni, s, W] ->
            # [ni*s, W] — a major-dims reshape, which is free.  (The
            # expensive part of the stack assembly is the LANE-dim
            # (nj, s) merge; this formulation never materializes it.)
            outs = []
            for p in range(s):
                rs = rowsums[p][:, P:P + gw]            # [n_i[p], gw, c]
                lhs = rs.transpose(2, 0, 1)[:, None]    # [c, 1, n_i, gw]
                ker = jnp.ones((1, 1, 1, ps), jnp.float32)
                o = lax.conv_general_dilated(
                    lhs, ker, window_strides=(1, 1),
                    padding=((0, 0), (pad_lo_x, pad_hi_x)),
                    lhs_dilation=(1, s),
                    dimension_numbers=("NCHW", "OIHW", "NCHW"),
                    precision=lax.Precision.HIGHEST,
                )[:, 0]                                 # [c, n_i, W]
                if o.shape[1] < ni_max:
                    o = jnp.pad(o, ((0, 0), (0, ni_max - o.shape[1]),
                                    (0, 0)))
                outs.append(o)
            full = jnp.stack(outs, axis=2)              # [c, ni_max, s, W]
            full = full.reshape(c, ni_max * s, width)
            return full[:, :height].transpose(1, 2, 0)
        if _ASSEMBLE == "conv":
            # Interleave as a conv: a one-hot transposed conv places
            # phase (p, q) at output (i*s+p, j*s+q) exactly (each output
            # is one 1.0*x product; HIGHEST precision keeps the copy
            # exact).
            # lhs channels ordered (p, q, ci); kernel tap (s-1-p, s-1-q)
            # routes phase p,q to output parity (p, q) under
            # lhs_dilation=s, padding=s-1.
            ph_all = jnp.stack(cols, axis=0)           # [s, ni, nj, s, c]
            lhs = ph_all.transpose(0, 3, 4, 1, 2).reshape(
                1, s * s * c, ni_max, nj_max)
            w = np.zeros((c, s * s * c, s, s), np.float32)
            for p in range(s):
                for q in range(s):
                    for ci in range(c):
                        w[ci, (p * s + q) * c + ci, s - 1 - p, s - 1 - q] = 1.0
            out = lax.conv_general_dilated(
                lhs, jnp.asarray(w), window_strides=(1, 1),
                padding=((s - 1, s - 1), (s - 1, s - 1)),
                lhs_dilation=(s, s),
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
                precision=lax.Precision.HIGHEST,
            )
            return out[0].transpose(1, 2, 0)[:height, :width]
        full = jnp.stack(cols, axis=1)                # [ni_max, s, nj_max, s, c]
        full = full.reshape(ni_max * s, nj_max * s, c)
        return full[:height, :width]

    return {"dilated": tconv_dilated, "batch": tconv_batch,
            "phases": tconv_phases}[_ALGO]
