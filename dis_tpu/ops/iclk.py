"""Batched inverse-compositional Lucas-Kanade patch search (pure JAX).

The reference runs one mutable state machine per patch, sequentially
(patch.cpp:119-203, dispatched from patch_grid.cpp:99-106).  Here the
whole grid is a struct-of-arrays batch and every iteration runs all
patches at once; frozen patches are masked, which preserves the
reference's per-patch semantics exactly (a frozen patch's ``u`` never
changes again, and its query resample has no observable effect).

Quirk-compat details (SURVEY.md §2):
- Q3: ``delta_u = H^-1 [sum(Tdx*Q); sum(Tdy*Q)]`` — the template is NOT
  subtracted in compat mode (patch.cpp:171-176).  Fixed mode uses the
  true residual ``Q - T`` (with the template mean-normalized when
  patch_normalization is on).
- Q5: no convergence test in compat mode; the loop body runs exactly
  ``iterations + 1`` times unless policing freezes a patch
  (counter semantics of patch.cpp:141,167,199).
- Q9: policing resets ``u`` to the scale's init and freezes the patch
  when it moves more than ``patch_size/2`` from its start position or
  leaves the valid region (patch.cpp:185-194).
- Q10: bilinear sampling addresses taps from ``ceil(pos + 1e-5)``
  computed in float32 (patch.cpp:222-234), reproduced bit-for-bit
  including the float32 rounding of the +1e-5 nudge.
"""

from __future__ import annotations

import os as _os
from typing import NamedTuple, Tuple

import jax.numpy as jnp
from jax import lax

from .. import backend
from ..config import DISConfig

# Template extraction form (all bit-exact): "auto" takes the platform's
# choice (dis_tpu/backend.py); "slices" (3*ps^2 strided slices),
# "twostage"/"twostage_rw" (separable row-then-column decimation),
# "twostage_rw_t" (the same on transposed planes), "stacked3"/"rw" and
# "conv" (one patches-conv at HIGHEST precision) stay selectable for
# measurement.
_TEMPLATES = _os.environ.get("DIS_TPU_TEMPLATES", "auto")


class PatchTemplates(NamedTuple):
    T: jnp.ndarray      # [N, ps*ps] raw template values
    Tdx: jnp.ndarray    # [N, ps*ps] template d/dx
    Tdy: jnp.ndarray    # [N, ps*ps] template d/dy
    Hinv: jnp.ndarray   # [N, 2, 2] inverse 2x2 Hessian


# A/B toggle for the round-4 bitwise-stability work (forced-association
# reductions).  "1" (default): pairwise trees behind optimization
# barriers — batched == serial bitwise.  "0": plain jnp.sum /
# compiler-chosen association — the pre-round-4 numerics, kept ONLY so
# the barrier cost can be measured on the card (tools/trace_budget.py).
# Not a supported operating point: batched
# pairs may drift 1 ulp from serial with it off.
_BITWISE_SUMS = _os.environ.get("DIS_TPU_BITWISE_SUMS", "1") != "0"


def pairwise_sum(x: jnp.ndarray) -> jnp.ndarray:
    """Sum over the last axis with a FORCED pairwise association tree.

    ``jnp.sum`` leaves the association to the compiler AND the program
    context: the identical Hessian reduction compiled 1 ulp different
    under ``jax.vmap`` (batched pairs) than serial on chip, which the
    search's discrete policing then amplified into real flow diffs
    (round 4).  Two-element reductions have no association freedom, so
    a log2 chain of trailing-pair reductions is bit-stable in every
    program context — this is what makes batched == serial bitwise.
    Odd lengths are zero-padded (x + 0.0 == x in f32 for every x except
    -0.0 -> +0.0, which compares equal and adds identically).

    The entry barrier is load-bearing too: the summand is typically a
    product (Tdx*Tdx, residual^2), and XLA fuses producer multiplies
    into the first add level as FMAs — picking different operands in
    different contexts (confirmed on chip: Hinv still differed batched
    vs serial with the tree alone).  Materializing the summand forces
    plain adds everywhere.
    """
    if not _BITWISE_SUMS:
        return jnp.sum(x, axis=-1)
    x = lax.optimization_barrier(x)
    while x.shape[-1] > 1:
        k = x.shape[-1]
        if k % 2:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, 1)])
            k += 1
        x = x.reshape(x.shape[:-1] + (k // 2, 2))
        # explicit binary add, NOT .sum(-1): a chain of trailing-pair
        # REDUCE ops is re-foldable into one reduce whose order is
        # implementation-defined again (observed on chip: the tree
        # alone changed nothing); an add's float semantics are fixed.
        x = x[..., 0] + x[..., 1]
    return x[..., 0]


def _tap_tree(vals):
    """Association-forced pair tree over a tap LIST: pure elementwise
    adds on per-tap planes — no stacks, no relayouts.  Pairing
    (0,1)(2,3)... per level matches :func:`pairwise_sum`, so the float
    adds — and results — are identical to the [N, ps*ps] tree bitwise.
    The barrier stops XLA from fusing the producer products into
    first-level FMAs (operand choice is context-dependent; chip
    round 4)."""
    if not _BITWISE_SUMS:
        return sum(vals[1:], vals[0])
    vals = list(lax.optimization_barrier(tuple(vals)))
    while len(vals) > 1:
        if len(vals) % 2:
            vals.append(jnp.zeros_like(vals[0]))
        vals = [vals[i] + vals[i + 1] for i in range(0, len(vals), 2)]
    return vals[0]


def extract_templates(img: jnp.ndarray, dx: jnp.ndarray, dy: jnp.ndarray,
                      centers: jnp.ndarray, ps: int, pad: int) -> PatchTemplates:
    """Template extraction at rounded centers + Hessian (patch.cpp:47-91).

    ``img``/``dx``/``dy`` are the padded level planes; ``centers`` [N, 2]
    are integer-valued patch centers in unpadded coords.
    """
    tmp_h, tmp_w = img.shape
    half = ps // 2
    offs = jnp.arange(-half, half)  # lb..ub inclusive
    px = jnp.round(centers[:, 0]).astype(jnp.int32) + pad
    py = jnp.round(centers[:, 1]).astype(jnp.int32) + pad
    rows = py[:, None, None] + offs[None, :, None]
    cols = px[:, None, None] + offs[None, None, :]
    idx = (rows * tmp_w + cols).reshape(centers.shape[0], ps * ps)
    T = jnp.take(img.ravel(), idx, axis=0)
    Tdx = jnp.take(dx.ravel(), idx, axis=0)
    Tdy = jnp.take(dy.ravel(), idx, axis=0)

    a = pairwise_sum(Tdx * Tdx)
    b = pairwise_sum(Tdx * Tdy)
    c = pairwise_sum(Tdy * Tdy)
    det = a * c - b * b
    guard = jnp.where(det == 0, jnp.float32(1e-10), jnp.float32(0.0))
    a = a + guard
    c = c + guard
    det = a * c - b * b
    inv_det = 1.0 / det
    Hinv = jnp.stack(
        [jnp.stack([c * inv_det, -b * inv_det], -1),
         jnp.stack([-b * inv_det, a * inv_det], -1)], -2)
    return PatchTemplates(T=T, Tdx=Tdx, Tdy=Tdy, Hinv=Hinv)


def extract_templates_grid(img: jnp.ndarray, dx: jnp.ndarray, dy: jnp.ndarray,
                           geom, ps: int, pad: int,
                           row0: int = 0) -> PatchTemplates:
    """Template extraction for a regular patch grid — gather-free.

    Patch centers sit on a regular ``steps``-strided lattice
    (patch_grid.cpp:43-44), so each of the ps*ps template taps is a
    strided slice of the level plane: 3 * ps^2 strided slices replace
    the 3 * N * ps^2-element gather.
    Produces patches in the reference's x-outer/y-inner order.
    """
    s = geom.steps
    half = ps // 2
    n = geom.num_w * geom.num_h
    # first included patch row, in local-plane coords (row0 = global
    # unpadded row of the stripe start; 0 when untiled)
    y0 = geom.iy0 * s + geom.offset_h - half + pad - row0
    x0 = geom.offset_w - half + pad

    mode = _TEMPLATES
    if mode == "auto":
        mode = backend.choices().templates

    if mode in ("twostage", "twostage_rw"):
        # Separable decimation: ps row-decimating slices, then ps^2
        # column-decimating passes on the s-times-smaller compacts,
        # instead of 3*ps^2 (s,s)-strided slices of the whole plane.  The
        # column pass is a strided slice ("twostage") or a window-1
        # stride-s reduce_window ("twostage_rw").
        p3 = jnp.stack([img, dx, dy])                   # [3, Hp, Wp]
        xe = x0 + (geom.num_w - 1) * s + ps
        rows = []
        for j in range(ps):
            yc = lax.slice(p3, (0, y0 + j, x0),
                           (3, y0 + j + (geom.num_h - 1) * s + 1, xe),
                           (1, s, 1))                   # [3, nh, xe-x0]
            rows.append(yc)
        taps = []
        for j in range(ps):
            for i in range(ps):
                if mode == "twostage_rw":
                    win = lax.slice(
                        rows[j], (0, 0, i),
                        (3, geom.num_h, i + (geom.num_w - 1) * s + 1))
                    taps.append(lax.reduce_window(
                        win, jnp.float32(0), lax.add,
                        (1, 1, 1), (1, 1, s), "VALID"))  # [3, nh, nw]
                else:
                    taps.append(lax.slice(
                        rows[j], (0, 0, i),
                        (3, geom.num_h, i + (geom.num_w - 1) * s + 1),
                        (1, 1, s)))                     # [3, nh, nw]
        # Hessian sums via _tap_tree: pure elementwise adds on [nh, nw]
        # planes — no stacks, no relayouts.
        dxs = [t[1] for t in taps]
        dys = [t[2] for t in taps]
        abc = [_tap_tree([x * x for x in dxs]),
               _tap_tree([x * y for x, y in zip(dxs, dys)]),
               _tap_tree([y * y for y in dys])]
        # [nh, nw] -> x-outer flat order (transpose to [nw, nh])
        a, b, c = (v.T.reshape(n) for v in abc)
        st = jnp.stack(taps, axis=-1)                   # [3, nh, nw, 64]
        st = st.transpose(0, 2, 1, 3).reshape(3, n, ps * ps)
        return _templates_from_hessian(st[0], st[1], st[2], a, b, c)

    if mode == "twostage_rw_t":
        # Transposed twostage_rw: decimate on TRANSPOSED planes so taps
        # land [3, nw, nh] and the reference's x-outer patch order is a
        # free major-dim ravel.  Identical tap values and identical
        # per-patch Hessian association as twostage_rw (the window-1
        # reduce_window is pure decimation, no arithmetic), verified
        # bitwise in tests/test_pipeline_parity.py.
        p3t = jnp.stack([img.T, dx.T, dy.T])            # [3, Wp, Hp]
        ye = y0 + (geom.num_h - 1) * s + ps
        cols = []
        for i in range(ps):
            xc = lax.slice(p3t, (0, x0 + i, y0),
                           (3, x0 + i + (geom.num_w - 1) * s + 1, ye),
                           (1, s, 1))                   # [3, nw, ye-y0]
            cols.append(xc)
        taps = []
        for j in range(ps):
            for i in range(ps):
                win = lax.slice(
                    cols[i], (0, 0, j),
                    (3, geom.num_w, j + (geom.num_h - 1) * s + 1))
                taps.append(lax.reduce_window(
                    win, jnp.float32(0), lax.add,
                    (1, 1, 1), (1, 1, s), "VALID"))     # [3, nw, nh]

        dxs = [t[1] for t in taps]
        dys = [t[2] for t in taps]
        abc = [_tap_tree([x * x for x in dxs]),
               _tap_tree([x * y for x, y in zip(dxs, dys)]),
               _tap_tree([y * y for y in dys])]
        a, b, c = (v.reshape(n) for v in abc)           # x-outer already
        st = jnp.stack(taps, axis=-1)                   # [3, nw, nh, 64]
        st = st.reshape(3, n, ps * ps)
        return _templates_from_hessian(st[0], st[1], st[2], a, b, c)

    if mode in ("stacked3", "rw"):
        # One [3, nh, nw] strided slice (or reduce_window decimation)
        # per tap instead of three: same copies, one third the op count.
        ye = y0 + (geom.num_h - 1) * s + 1
        xe = x0 + (geom.num_w - 1) * s + 1
        p3 = jnp.stack([img, dx, dy])                   # [3, Hp, Wp]
        taps = []
        for j in range(ps):
            for i in range(ps):
                if mode == "rw":
                    win = lax.slice(p3, (0, y0 + j, x0 + i),
                                    (3, ye + j, xe + i))
                    t = lax.reduce_window(win, jnp.float32(0), lax.add,
                                          (1, 1, 1), (1, s, s), "VALID")
                else:
                    t = lax.slice(p3, (0, y0 + j, x0 + i),
                                  (3, ye + j, xe + i), (1, s, s))
                taps.append(t)                          # [3, nh, nw]
        st = jnp.stack(taps, axis=-1)                   # [3, nh, nw, 64]
        st = st.transpose(0, 2, 1, 3).reshape(3, n, ps * ps)
        return _templates_from_taps(st[0], st[1], st[2])

    if mode == "conv":
        # One patches-conv for all three planes replaces 3*ps^2 strided
        # slices.  The one-hot identity filter at HIGHEST precision
        # copies taps exactly (each output is one 1.0*x product plus
        # zeros) — bit-identical to the slice path
        # (tests/test_pipeline_parity.py::test_templates_conv_matches_slices).
        ye = y0 + (geom.num_h - 1) * s + ps
        xe = x0 + (geom.num_w - 1) * s + ps
        p3 = jnp.stack([img[y0:ye, x0:xe], dx[y0:ye, x0:xe],
                        dy[y0:ye, x0:xe]])[None]          # [1, 3, Hw, Ww]
        pat = lax.conv_general_dilated_patches(
            p3, (ps, ps), (s, s), "VALID",
            precision=lax.Precision.HIGHEST)[0]           # [3*ps^2, nh, nw]
        # channel order is plane-major then (j, i) — verified vs slices
        flat = pat.transpose(2, 1, 0).reshape(n, 3 * ps * ps)  # x-outer
        T = flat[:, :ps * ps]
        Tdx = flat[:, ps * ps:2 * ps * ps]
        Tdy = flat[:, 2 * ps * ps:]
        return _templates_from_taps(T, Tdx, Tdy)

    def tap_stack(plane):
        cols = []
        for j in range(ps):
            for i in range(ps):
                sl = lax.slice(
                    plane,
                    (y0 + j, x0 + i),
                    (y0 + j + (geom.num_h - 1) * s + 1,
                     x0 + i + (geom.num_w - 1) * s + 1),
                    (s, s))          # [num_h, num_w]
                cols.append(sl)
        st = jnp.stack(cols, axis=-1)            # [num_h, num_w, ps*ps]
        return st.transpose(1, 0, 2).reshape(n, ps * ps)  # x-outer order

    T = tap_stack(img)
    Tdx = tap_stack(dx)
    Tdy = tap_stack(dy)
    return _templates_from_taps(T, Tdx, Tdy)


def _templates_from_taps(T: jnp.ndarray, Tdx: jnp.ndarray,
                         Tdy: jnp.ndarray) -> PatchTemplates:
    """2x2 Gauss-Newton Hessian + det==0 guard (patch.cpp:75-91)."""
    a = pairwise_sum(Tdx * Tdx)
    b = pairwise_sum(Tdx * Tdy)
    c = pairwise_sum(Tdy * Tdy)
    return _templates_from_hessian(T, Tdx, Tdy, a, b, c)


def _templates_from_hessian(T, Tdx, Tdy, a, b, c) -> PatchTemplates:
    """Assemble PatchTemplates from precomputed Hessian sums (the
    two-stage template forms compute them in tap-major layout; same
    association tree as pairwise_sum, so both spellings agree bitwise)."""
    det = a * c - b * b
    guard = jnp.where(det == 0, jnp.float32(1e-10), jnp.float32(0.0))
    a = a + guard
    c = c + guard
    det = a * c - b * b
    inv_det = 1.0 / det
    Hinv = jnp.stack(
        [jnp.stack([c * inv_det, -b * inv_det], -1),
         jnp.stack([-b * inv_det, a * inv_det], -1)], -2)
    return PatchTemplates(T=T, Tdx=Tdx, Tdy=Tdy, Hinv=Hinv)


def sample_patches(img2: jnp.ndarray, pos: jnp.ndarray, ps: int, pad: int,
                   normalize: bool, row0: int = 0) -> jnp.ndarray:
    """Bilinear warped query patches [N, ps*ps] (patch.cpp:207-267).

    One gathered (ps+1)x(ps+1) window per patch, combined as four
    shifted taps with the reference's exact weight/tap pairing; tap base
    is ``ceil(pos + 1e-5)`` in float32 (Q10).  Out-of-range positions
    (possible only for masked/frozen patches) are index-clipped.
    """
    tmp_h, tmp_w = img2.shape
    n = pos.shape[0]
    half = ps // 2
    posx = pos[:, 0].astype(jnp.float32)
    posy = pos[:, 1].astype(jnp.float32)
    l = jnp.floor(posx)
    k = jnp.floor(posy)
    a = posx - l
    b = posy - k
    w0 = (1 - a) * (1 - b)
    w1 = a * (1 - b)
    w2 = b * (1 - a)
    w3 = a * b

    # float32 ceil(pos + 1e-5); clip before int cast to keep the cast
    # defined for wildly out-of-range (frozen-patch) positions.
    nudge = jnp.float32(1e-5)
    cpx = jnp.clip(jnp.ceil(posx + nudge), -1e6, 1e6).astype(jnp.int32) + pad
    cpy = (jnp.clip(jnp.ceil(posy + nudge), -1e6, 1e6).astype(jnp.int32)
           + pad - row0)

    doff = jnp.arange(ps + 1)
    rows = jnp.clip((cpy - half - 1)[:, None, None] + doff[None, :, None], 0, tmp_h - 1)
    cols = jnp.clip((cpx - half - 1)[:, None, None] + doff[None, None, :], 0, tmp_w - 1)
    idx = (rows * tmp_w + cols).reshape(n, (ps + 1) * (ps + 1))
    W = jnp.take(img2.ravel(), idx, axis=0).reshape(n, ps + 1, ps + 1)

    q = (w3[:, None, None] * W[:, 1:, 1:]
         + w2[:, None, None] * W[:, 1:, :-1]
         + w1[:, None, None] * W[:, :-1, 1:]
         + w0[:, None, None] * W[:, :-1, :-1]).reshape(n, ps * ps)
    if normalize:
        q = q - q.sum(axis=1, keepdims=True) * jnp.float32(1.0 / (ps * ps))
    return q


# f32 contractions (the region sampler's one-hot einsum and the Hinv
# matvec) run at HIGHEST precision: on the GPU the default precision of
# an f32 product may be TF32, which keeps ~3 decimal digits and would
# corrupt every sampled value and search step.
_PREC = lax.Precision.HIGHEST


def region_shape(ps: int) -> Tuple[int, int]:
    """(rows, cols) of the per-patch sampling region."""
    return 2 * ps + 3, 2 * ps + 3


def extract_regions(img2: jnp.ndarray, pos0: jnp.ndarray, ps: int,
                    pad: int, row0: int = 0
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-patch sampling regions for one scale: [N, R, R] with
    R = 2*ps + 3.

    Outlier policing (patch.cpp:185-194) bounds every sampled position
    within ``ps/2`` of the scale's start position, so all of a patch's
    bilinear windows across all iterations live in a fixed
    (2*ps+1)^2 neighborhood of the start; the extra rows/cols cover
    float32 rounding slack at the policing boundary.  Every subsequent
    iteration samples from these regions without touching the image.

    Returns (regions, base_y, base_x) where base is the region origin
    in padded-image coordinates.
    """
    th, tw = img2.shape
    half = ps // 2
    rr, rc = region_shape(ps)
    n = pos0.shape[0]
    nudge = jnp.float32(1e-5)
    cpx0 = jnp.clip(jnp.ceil(pos0[:, 0] + nudge), -1e6, 1e6).astype(jnp.int32) + pad
    cpy0 = (jnp.clip(jnp.ceil(pos0[:, 1] + nudge), -1e6, 1e6).astype(jnp.int32)
            + pad - row0)
    base_y = jnp.clip(cpy0 - ps - 2, 0, th - rr)
    base_x = jnp.clip(cpx0 - half - 1 - (half + 1), 0, tw - rc)

    # Sliding windows along x: S[h, x, k] = img2[h, x + k]; one gathered
    # row of S is one region row.
    ncols = tw - rc + 1
    S = jnp.stack([img2[:, k:k + ncols] for k in range(rc)], axis=-1)
    S2 = S.reshape(th * ncols, rc)
    rowidx = ((base_y[:, None] + jnp.arange(rr)[None, :]) * ncols
              + base_x[:, None])
    regions = jnp.take(S2, rowidx.reshape(-1), axis=0).reshape(n, rr, rc)
    return regions, base_y, base_x


def sample_from_regions(regions: jnp.ndarray, base_y: jnp.ndarray,
                        base_x: jnp.ndarray, pos: jnp.ndarray, ps: int,
                        pad: int, normalize: bool,
                        row0: int = 0) -> jnp.ndarray:
    """Bilinear warped query patches from pre-extracted regions.

    Mathematically identical to :func:`sample_patches` (same ceil-nudge
    tap base Q10, same weight/tap pairing, separably factored): the
    4-tap bilinear combination factors into a row selector
    [(1-b) at window row j, b at j+1] and a column selector
    [(1-a) at i, a at i+1], applied as batched one-hot contractions.
    """
    n, rrows, rcols = regions.shape
    half = ps // 2
    posx = pos[:, 0].astype(jnp.float32)
    posy = pos[:, 1].astype(jnp.float32)
    a = posx - jnp.floor(posx)
    b = posy - jnp.floor(posy)

    nudge = jnp.float32(1e-5)
    cpx = jnp.clip(jnp.ceil(posx + nudge), -1e6, 1e6).astype(jnp.int32) + pad
    cpy = (jnp.clip(jnp.ceil(posy + nudge), -1e6, 1e6).astype(jnp.int32)
           + pad - row0)
    # local window start (row of tap W[0,0] = img[cpy-half-1])
    ws = jnp.clip(cpy - half - 1 - base_y, 0, rrows - (ps + 1))  # [N]
    cs = jnp.clip(cpx - half - 1 - base_x, 0, rcols - (ps + 1))

    jj = jnp.arange(ps)[None, :, None]       # output row j
    rr = jnp.arange(rrows)[None, None, :]    # region row r
    rs = ((rr == ws[:, None, None] + jj).astype(jnp.float32)
          * (1 - b)[:, None, None]
          + (rr == ws[:, None, None] + jj + 1).astype(jnp.float32)
          * b[:, None, None])                # [N, ps, Rr]
    cc = jnp.arange(rcols)[None, :, None]    # region col c
    ii = jnp.arange(ps)[None, None, :]       # output col i
    csel = ((cc == cs[:, None, None] + ii).astype(jnp.float32)
            * (1 - a)[:, None, None]
            + (cc == cs[:, None, None] + ii + 1).astype(jnp.float32)
            * a[:, None, None])              # [N, Rc, ps]

    # HIGHEST keeps the one-hot selector contraction exact (see _PREC;
    # the CPU ignores precision, so CPU tests cannot catch a lower one).
    q = jnp.einsum("njr,nrc,nci->nji", rs, regions, csel,
                   preferred_element_type=jnp.float32,
                   precision=_PREC).reshape(n, ps * ps)
    if normalize:
        q = q - q.sum(axis=1, keepdims=True) * jnp.float32(1.0 / (ps * ps))
    return q


class SearchResult(NamedTuple):
    u: jnp.ndarray          # [N, 2] final displacement per patch
    Q: jnp.ndarray          # [N, ps*ps] final warped query patch
    converged: jnp.ndarray  # [N] bool
    start_oob: jnp.ndarray  # [N] bool: start position was out of bounds, so
    #                         the patch froze immediately and Q is the raw
    #                         template, not a resample (patch.cpp:132-136)


def inverse_search(img2: jnp.ndarray, tpl: PatchTemplates,
                   centers: jnp.ndarray, init_u: jnp.ndarray,
                   cfg: DISConfig, width: int, height: int,
                   row0=0) -> SearchResult:
    """Run the full IC-LK iteration for every patch at one scale.

    Valid-region bounds from optical_flow.cpp:55-57:
    ``tmp_lb = -ps/2``, ``tmp_ub_w = w + ps/2 - 2``, ``tmp_ub_h = h + ps/2 - 2``.

    Which search runs is :func:`dis_tpu.backend.search_kernel`'s choice:
    the fused Pallas-Triton kernel on the GPU, the XLA loop below on the
    CPU (``cfg.kernel`` can pin either where it runs).
    """
    ps = cfg.patch_size
    pad = cfg.img_padding
    lb = jnp.float32(-float(ps) / 2.0)
    ub_w = jnp.float32(width + ps // 2 - 2)
    ub_h = jnp.float32(height + ps // 2 - 2)
    thresh = jnp.float32(cfg.outlier_thresh)
    fixed = cfg.mode == "fixed"

    Tn = tpl.T
    if fixed and cfg.patch_normalization:
        Tn = tpl.T - pairwise_sum(tpl.T)[:, None] * jnp.float32(1.0 / (ps * ps))

    def oob(p):
        return ((p[:, 0] < lb) | (p[:, 1] < lb)
                | (p[:, 0] > ub_w) | (p[:, 1] > ub_h))

    init_u = init_u.astype(jnp.float32)
    pos0 = centers + init_u
    start = pos0
    conv0 = oob(pos0)
    start_oob = conv0

    if backend.search_kernel(cfg.kernel) == "pallas":
        from .pallas.iclk_kernel import inverse_search_pallas

        u, q, conv = inverse_search_pallas(
            img2, tpl.T, tpl.Tdx, tpl.Tdy, Tn, tpl.Hinv, centers, init_u,
            conv0, cfg, width, height, row0=row0)
        _guard_result(u, q, centers, init_u, pos0, thresh, cfg)
        return SearchResult(u=u, Q=q, converged=conv, start_oob=conv0)

    if cfg.sampler == "region":
        regions, base_y, base_x = extract_regions(img2, pos0, ps, pad,
                                                  row0=row0)

        def sampler(pos):
            return sample_from_regions(regions, base_y, base_x, pos, ps, pad,
                                       cfg.patch_normalization, row0=row0)
    else:
        def sampler(pos):
            return sample_patches(img2, pos, ps, pad,
                                  cfg.patch_normalization, row0=row0)

    Q0 = jnp.where(conv0[:, None], tpl.T, sampler(pos0))

    # Under shard_map the loop carry must have a consistent
    # varying-across-devices type: at the coarsest scale ``init_u`` is a
    # replicated constant while the body makes ``u``/``converged``
    # device-varying.  Seed both from the (always-varying) image via an
    # identically-False predicate (NaN-safe: NaN - NaN > 1 is False).
    vfalse = (img2.ravel()[0] - img2.ravel()[0]) > jnp.float32(1.0)
    u0 = jnp.where(vfalse, jnp.float32(0), init_u)
    conv0 = jnp.where(vfalse, True, conv0)

    def body(state):
        it, u, Q, converged = state
        active = ~converged
        R = Q - Tn if fixed else Q
        rhs = jnp.stack([(tpl.Tdx * R).sum(axis=1),
                         (tpl.Tdy * R).sum(axis=1)], -1)
        # HIGHEST: keep the 2x2 solve in true f32 (no TF32; see _PREC).
        delta = jnp.einsum("nij,nj->ni", tpl.Hinv, rhs, precision=_PREC)
        u_new = u - delta
        p_new = centers + u_new
        d = start - p_new
        dist = jnp.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
        policed = (dist > thresh) | oob(p_new)
        u_next = jnp.where(policed[:, None], init_u, u_new)
        u = jnp.where(active[:, None], u_next, u)
        pos = centers + u
        Qs = sampler(pos)
        Q = jnp.where(active[:, None], Qs, Q)
        newly_done = active & policed
        if fixed:
            small = jnp.sqrt((delta * delta).sum(-1)) < jnp.float32(cfg.conv_eps)
            newly_done = newly_done | (active & small)
        return it + 1, u, Q, converged | newly_done

    n_iters = cfg.iterations + 1  # counter_iter runs 1..iterations+1

    if cfg.early_exit:
        def cond(state):
            it, _, _, converged = state
            return (it < n_iters) & (~jnp.all(converged))
        _, u, Q, converged = lax.while_loop(cond, body, (0, u0, Q0, conv0))
    else:
        def fbody(i, state):
            return body(state)
        _, u, Q, converged = lax.fori_loop(0, n_iters, fbody, (0, u0, Q0, conv0))
    _guard_result(u, Q, centers, init_u, pos0, thresh, cfg)
    return SearchResult(u=u, Q=Q, converged=converged, start_oob=start_oob)


def _guard_result(u, Q, centers, init_u, start, thresh, cfg) -> None:
    """DIS_TPU_CHECK invariants on a scale's search result: finite
    state, and the Q9 policing guarantee — every patch's final position
    is within ``outlier_thresh`` of its start OR exactly reset to the
    init (patch.cpp:185-194).  No-ops unless checks are enabled."""
    from ..utils import checks

    if not checks.enabled():
        return
    checks.check(jnp.isfinite(u).all(), "IC-LK produced non-finite u")
    checks.check(jnp.isfinite(Q).all(), "IC-LK produced non-finite Q")
    d = start - (centers + u)
    dist = jnp.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
    at_init = jnp.all(u == init_u, axis=1)
    ok = (dist <= jnp.float32(thresh) + 1e-3) | at_init
    checks.check(ok.all(), "policing invariant violated: patch moved "
                 "beyond outlier_thresh without reset")
