"""Variational refinement of the densified flow field.

The DIS paper (Kroeger et al., ECCV 2016, sec. 3.3) refines the
patch-densified flow with the Brox-style variational energy

    E(U) = int  delta * Psi(|I2(x+U) - I1(x)|^2)
              + gamma * Psi(|grad I2(x+U) - grad I1(x)|^2)
              + alpha * Psi(|grad u|^2 + |grad v|^2)

with Psi(s^2) = sqrt(s^2 + eps^2).  The reference implementation skips
this step entirely (``/root/reference/README.md:11``: "We skip step Fast
Variational refinement"); it is reinstated here because BASELINE.json's
north star requires it.

Formulation: IRLS outer iterations (warp + lagged robust
weights) with red-black Gauss-Seidel inner sweeps.  Red-black updates
are expressed as dense masked updates over the full grid — two masked
half-sweeps per iteration — which keeps every step a fused elementwise
stencil; no scatter, no data-dependent control flow.

Structure knobs (cfg): ``refinement_iters`` outer warps /
re-linearizations; per warp, ``refinement_inner_sweeps`` lagged
robust-weight (fixed-point) updates; per weight update,
``refinement_sor_sweeps`` red-black SOR sweeps with factor
``refinement_omega``.  The paper form — what the DIS authors' own
OpenCV ``VariationalRefinement`` does per pyramid level — is ONE warp,
5 fixed-point updates, 5 SOR sweeps, omega 1.6 (presets DIS_MEDIUM /
DIS_FULL); measured both faster (1/5 the warp cost) and more accurate
than re-warping outers on the six synthetic motion families.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax.numpy as jnp
from jax import lax

from ..config import DISConfig
from . import image as im

# Warp gather formulation (bit-identical tap values):
#   take4  — four C-wide row takes.
#   take2  — two gathers of [2, C] row-pair slices from width+1
#            replicate-padded planes (x1 = x0+1 always valid, so the
#            right-edge clamp folds into the padding).  Halves the
#            gather rows.
#   slice1 — one gather of [2, 2, C] corner slices from (H+1, W+1)
#            replicate-padded planes.
_WARP = os.environ.get("DIS_TPU_WARP", "take4")

# Python-unroll refinement loops whose trip count is at most this bound
# (default covers every preset: DIS_FULL is 1 outer x 10 inner).  The
# round-3 bisect showed lax.scan is the one construct
# that breaks bitwise tiled==untiled parity: XLA compiles a scan BODY
# with context-dependent fma/fusion choices, so the identical refinement
# jaxpr produces ulp-different flow inside an SPMD-partitioned module vs
# the plain jit module (amplified to ~1e-4 by subsequent scale searches).
# Unrolled, the same ops compile identically in both contexts.  Large
# counts fall back to lax.scan to bound compile time.
_UNROLL_MAX = int(os.environ.get("DIS_TPU_REFINE_UNROLL", "16"))


def _iterate(f, init, length: int):
    """scan-with-no-xs that Python-unrolls small trip counts (see
    _UNROLL_MAX note: load-bearing for bitwise tiled==untiled parity)."""
    if length <= _UNROLL_MAX:
        c = init
        for _ in range(length):
            c, _ = f(c, None)
        return c
    c, _ = lax.scan(f, init, None, length=length)
    return c


# Charbonnier epsilon^2 per term.  The classic eps=1e-3 assumes
# intensities normalized to [0, 1]; this pipeline works on 0..255
# planes, so the data/gradient epsilon is scaled accordingly (eps=0.1
# intensity units) — with the unscaled value the IRLS inner iteration
# oscillates around the |r|=0 kink instead of converging (measured:
# lagged-weight limit cycle with wd ~ 5e2 at r ~ 4e-3).  The smoothness
# term is in flow units (px), where the small epsilon is appropriate.
_EPS2_DATA = 1e-2
_EPS2_SMOOTH = 1e-6


def _warp_bilinear(planes: jnp.ndarray, flow: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sample stacked ``planes`` [H, W, C] at ``x + flow`` (edge clamp).

    One shared set of tap indices/weights warps all C planes at once
    (the refinement needs 6 warped planes per outer iteration; sharing
    the gather indices is ~6x cheaper than per-plane warps).
    Returns (warped [H, W, C], in_bounds [H, W]).

    Formulation note: four C-wide takes share one set of indices;
    ``DIS_TPU_WARP`` selects the bit-identical alternatives.  (An
    isolated packed-take microbenchmark misleads when closure-constant
    flow lets XLA constant-fold the indices.)
    """
    h, w, c = planes.shape
    ys, xs = jnp.mgrid[0:h, 0:w]
    fx = xs + flow[..., 0]
    fy = ys + flow[..., 1]
    inb = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    fxc = jnp.clip(fx, 0.0, w - 1.0)
    fyc = jnp.clip(fy, 0.0, h - 1.0)
    x0 = jnp.floor(fxc).astype(jnp.int32)
    y0 = jnp.floor(fyc).astype(jnp.int32)
    a = (fxc - x0)[..., None]
    b = (fyc - y0)[..., None]

    # Tap values are identical across formulations: x0 <= w-1 always, and
    # when x0 == w-1 the replicate-padded column w equals column w-1 —
    # exactly what the min(x0+1, w-1) clamp of the take4 path reads
    # (likewise for y), so the blend consumes the same four corners.
    if _WARP == "take4":
        x1 = jnp.minimum(x0 + 1, w - 1)
        y1 = jnp.minimum(y0 + 1, h - 1)
        flat = planes.reshape(h * w, c)

        def g(yy, xx):
            return jnp.take(flat, yy * w + xx, axis=0)

        c00, c01 = g(y0, x0), g(y0, x1)
        c10, c11 = g(y1, x0), g(y1, x1)
    else:
        pp = jnp.concatenate([planes, planes[:, -1:, :]], axis=1)
        pp = jnp.concatenate([pp, pp[-1:, :, :]], axis=0)  # [h+1, w+1, c]
        m = h * w
        if _WARP == "slice1":
            idx = jnp.stack([y0.reshape(m), x0.reshape(m)], axis=-1)
            dn = lax.GatherDimensionNumbers(
                offset_dims=(1, 2, 3), collapsed_slice_dims=(),
                start_index_map=(0, 1))
            quad = lax.gather(pp, idx, dn, slice_sizes=(2, 2, c))  # [M,2,2,c]
            c00 = quad[:, 0, 0].reshape(h, w, c)
            c01 = quad[:, 0, 1].reshape(h, w, c)
            c10 = quad[:, 1, 0].reshape(h, w, c)
            c11 = quad[:, 1, 1].reshape(h, w, c)
        else:  # take2: two row-pair gathers
            flat = pp.reshape((h + 1) * (w + 1), c)
            base = (y0 * (w + 1) + x0).reshape(m, 1)
            dn = lax.GatherDimensionNumbers(
                offset_dims=(1, 2), collapsed_slice_dims=(),
                start_index_map=(0,))

            def g2(ind):
                return lax.gather(flat, ind, dn, slice_sizes=(2, c))

            row0 = g2(base)                 # [M, 2, c]: (y0,x0), (y0,x0+1)
            row1 = g2(base + (w + 1))       # [M, 2, c]: (y1,x0), (y1,x0+1)
            c00 = row0[:, 0].reshape(h, w, c)
            c01 = row0[:, 1].reshape(h, w, c)
            c10 = row1[:, 0].reshape(h, w, c)
            c11 = row1[:, 1].reshape(h, w, c)

    out = ((1 - a) * (1 - b) * c00 + a * (1 - b) * c01
           + (1 - a) * b * c10 + a * b * c11)
    return out, inb


def _psi_deriv(s2: jnp.ndarray, eps2: float) -> jnp.ndarray:
    """Psi'(s^2) = 1 / (2 sqrt(s^2 + eps^2)) — the IRLS weight."""
    return 0.5 * lax.rsqrt(s2 + jnp.float32(eps2))


def variational_refinement(img1_padded: jnp.ndarray, img2_padded: jnp.ndarray,
                           flow: jnp.ndarray, cfg: DISConfig,
                           pad: Optional[int] = None) -> jnp.ndarray:
    """Refine ``flow`` [h, w, 2] given the level image planes.

    ``pad`` is the border width to slice off the planes (default
    ``cfg.img_padding``, matching the Q1 pyramid levels; pass 0 for the
    exact-size intensity planes of ``refinement_planes="intensity"``).
    With the default Q1 planes the data term is consistent with what
    the patch search matched; with intensity planes it is what the DIS
    paper's refinement reads (see config.py::refinement_planes).
    """
    h, w = flow.shape[:2]
    p = cfg.img_padding if pad is None else pad
    I1 = img1_padded[p:p + h, p:p + w]
    I2 = img2_padded[p:p + h, p:p + w]

    I1x = im.sobel3(I1, "x")
    I1y = im.sobel3(I1, "y")
    warp1 = cfg.refinement_scheme == "warp1"
    if warp1:
        # Only I2 itself is warped; gradients come from Sobel of the
        # warped image (see below).
        planes = I2[..., None]
    else:
        I2x = im.sobel3(I2, "x")
        I2y = im.sobel3(I2, "y")
        I2xx = im.sobel3(I2x, "x")
        I2xy = im.sobel3(I2x, "y")
        I2yy = im.sobel3(I2y, "y")
        planes = jnp.stack([I2, I2x, I2y, I2xx, I2xy, I2yy], axis=-1)

    alpha = jnp.float32(cfg.refinement_alpha)
    delta = jnp.float32(cfg.refinement_delta)
    gamma = jnp.float32(cfg.refinement_gamma)

    ys, xs = jnp.mgrid[0:h, 0:w]
    red = ((xs + ys) % 2 == 0).astype(jnp.float32)
    black = 1.0 - red
    omega = jnp.float32(cfg.refinement_omega)

    def _shift_edge(x, dy, dx):
        """Neighbor value at (y+dy, x+dx) with replicate border."""
        xp = jnp.pad(x, ((1, 1), (1, 1)), mode="edge")
        return xp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    def outer(flow, _):
        u0 = flow[..., 0]
        v0 = flow[..., 1]
        if warp1:
            # Warp only I2 (one-plane gather), then differentiate the
            # WARPED image and average with I1's gradients — the
            # gradient-averaging linearization of the DIS authors' own
            # OpenCV VariationalRefinement (prepareBuffers computes Ix =
            # 0.5*(dI0 + d warped I1), Iz = warped - I0, Izx = d(Iz)).
            # 1/6th the gather work of the six-plane warp.
            warped, inb = _warp_bilinear(planes, flow)
            W = warped[..., 0]
            Wxr = im.sobel3(W, "x")
            Wyr = im.sobel3(W, "y")
            Wx = 0.5 * (I1x + Wxr)
            Wy = 0.5 * (I1y + Wyr)
            Iz = W - I1
            Izx = Wxr - I1x
            Izy = Wyr - I1y
            Wxx = im.sobel3(Wx, "x")
            Wxy = im.sobel3(Wx, "y")
            Wyy = im.sobel3(Wy, "y")
        else:
            # Warp I2 and its derivative planes with one shared gather.
            warped, inb = _warp_bilinear(planes, flow)
            W, Wx, Wy, Wxx, Wxy, Wyy = [warped[..., i] for i in range(6)]
            Iz = W - I1
            Izx = Wx - I1x
            Izy = Wy - I1y
        m = inb.astype(jnp.float32)

        def inner(carry, _):
            du, dv = carry
            # Lagged robust weights.
            r_d = Iz + Wx * du + Wy * dv
            wd = delta * _psi_deriv(r_d * r_d, _EPS2_DATA) * m
            r_gx = Izx + Wxx * du + Wxy * dv
            r_gy = Izy + Wxy * du + Wyy * dv
            wg = gamma * _psi_deriv(r_gx * r_gx + r_gy * r_gy, _EPS2_DATA) * m

            U = u0 + du
            V = v0 + dv
            Ux = _shift_edge(U, 0, 1) - U
            Uy = _shift_edge(U, 1, 0) - U
            Vx = _shift_edge(V, 0, 1) - V
            Vy = _shift_edge(V, 1, 0) - V
            ws_c = alpha * _psi_deriv(Ux * Ux + Uy * Uy + Vx * Vx + Vy * Vy,
                                      _EPS2_SMOOTH)

            # Edge weights: average of the endpoint diffusivities.
            def edge_w(dy, dx):
                return 0.5 * (ws_c + _shift_edge(ws_c, dy, dx))

            wE = edge_w(0, 1)
            wW = edge_w(0, -1)
            wS = edge_w(1, 0)
            wN = edge_w(-1, 0)
            S = wE + wW + wS + wN

            A11 = wd * Wx * Wx + wg * (Wxx * Wxx + Wxy * Wxy) + S
            A12 = wd * Wx * Wy + wg * (Wxy * (Wxx + Wyy))
            A22 = wd * Wy * Wy + wg * (Wxy * Wxy + Wyy * Wyy) + S
            b1c = -(wd * Wx * Iz + wg * (Wxx * Izx + Wxy * Izy))
            b2c = -(wd * Wy * Iz + wg * (Wxy * Izx + Wyy * Izy))

            def half_sweep(du, dv, mask):
                nU = (wE * _shift_edge(u0 + du, 0, 1) + wW * _shift_edge(u0 + du, 0, -1)
                      + wS * _shift_edge(u0 + du, 1, 0) + wN * _shift_edge(u0 + du, -1, 0))
                nV = (wE * _shift_edge(v0 + dv, 0, 1) + wW * _shift_edge(v0 + dv, 0, -1)
                      + wS * _shift_edge(v0 + dv, 1, 0) + wN * _shift_edge(v0 + dv, -1, 0))
                b1 = b1c + nU - S * u0
                b2 = b2c + nV - S * v0
                det = A11 * A22 - A12 * A12
                det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
                du_new = (A22 * b1 - A12 * b2) / det
                dv_new = (A11 * b2 - A12 * b1) / det
                # Block SOR: over-relax the exact 2x2 point solve
                # (omega=1 is plain red-black Gauss-Seidel, kept as the
                # direct assignment so it stays bit-identical).
                if cfg.refinement_omega != 1.0:
                    du_new = du + omega * (du_new - du)
                    dv_new = dv + omega * (dv_new - dv)
                du = jnp.where(mask > 0, du_new, du)
                dv = jnp.where(mask > 0, dv_new, dv)
                return du, dv

            for _ in range(cfg.refinement_sor_sweeps):
                du, dv = half_sweep(du, dv, red)
                du, dv = half_sweep(du, dv, black)
            return (du, dv), None

        du, dv = _iterate(inner, (jnp.zeros_like(u0), jnp.zeros_like(v0)),
                          cfg.refinement_inner_sweeps)
        new_flow = jnp.stack([u0 + du, v0 + dv], axis=-1)
        return new_flow, None

    return _iterate(outer, flow, cfg.refinement_iters)
