"""Coarse-to-fine DIS orchestrator (optical_flow.cpp:19-132), jit-able.

The reference runs the whole algorithm inside a class constructor over
mutable per-scale state; here it is a pure function
``flow = dis_flow(img1, img2, cfg)``.  Scale shapes are static, so the
scale loop is a Python loop unrolled at trace time — each scale is a
distinct static-shape stage, which is exactly what XLA wants.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import DISConfig
from ..ops import image as im
from ..ops import iclk
from ..ops.densify import densify
from ..ops.grid import make_grid, init_from_coarser_flow
from ..ops.pyramid import construct_pyramid, intensity_pyramid
from ..ops.variational import variational_refinement


def _fixed_weights(res, tpl, cfg: DISConfig) -> jnp.ndarray:
    """Residual-adaptive densification weights (DIS paper eq. 4):
    ``1 / max(1, ||Q - T||^2)`` with the mean-normalized template.

    Patches frozen at start (OOB init, quirk path patch.cpp:132-136)
    never resampled: their ``Q`` is the raw template, so the residual
    would be the template's mean energy, not an intensity error.  Those
    patches get a defined constant weight of 1.0 instead (the same rule
    lives in oracle/reference_semantics.py; since round 4 the pipeline
    sums with the forced ``pairwise_sum`` association while the oracle
    uses plain ``np.sum``, so pipeline/oracle agreement here is to
    float tolerance, not bitwise).
    """
    from ..ops.iclk import pairwise_sum

    ps2 = cfg.num_points_patch
    Tn = tpl.T
    if cfg.patch_normalization:
        # pairwise_sum: association-forced so batched == serial bitwise
        Tn = Tn - pairwise_sum(Tn)[:, None] / ps2
    r2 = pairwise_sum((res.Q - Tn) ** 2)
    return jnp.where(res.start_oob, jnp.float32(1.0),
                     1.0 / jnp.maximum(1.0, r2))


def window_patch_rows(cfg: DISConfig, gh_s: int, win_lo: int,
                      win_hi: int) -> tuple:
    """Global patch-row range [iy0, iy1) whose ps x ps footprints
    intersect output rows [win_lo, win_hi) at a scale of global height
    ``gh_s``.  A patch at center ``cy`` covers rows
    ``[cy - ps/2, cy + ps/2 - 1]`` (patch_grid.cpp:132-165)."""
    import math as _m

    half = cfg.patch_size // 2
    steps = cfg.steps
    num_h = _m.ceil(gh_s / steps)
    offh = _m.floor((gh_s - (num_h - 1) * steps) / 2)
    cy_lo = win_lo - half + 1
    cy_hi = win_hi - 1 + half
    iy0 = max(0, _m.ceil((cy_lo - offh) / steps))
    iy1 = min(num_h, _m.floor((cy_hi - offh) / steps) + 1)
    return iy0, iy1


def build_refinement_planes(img1_padded: jnp.ndarray,
                            img2_padded: jnp.ndarray, cfg: DISConfig):
    """Per-scale intensity planes for the refinement data term, or None
    when refinement reads the Q1 pyramid levels (or is disabled).  The
    returned pair of lists is indexed by scale and passed through
    :func:`refine_level` / the final-scale refinement unchanged in the
    untiled and tiled engines (identical program => bitwise-identical
    results across modes).  See config.py::refinement_planes."""
    if cfg.refinement_iters == 0 or cfg.refinement_planes == "q1":
        return None
    return (intensity_pyramid(img1_padded, cfg.coarsest_scale),
            intensity_pyramid(img2_padded, cfg.coarsest_scale))


def refine_level(l1, l2, flow: jnp.ndarray, cfg: DISConfig,
                 scale: int, planes=None) -> jnp.ndarray:
    """Per-level variational refinement at ``scale``, shared by the
    untiled, grid-tiled and host-tiled pipelines (identical program =>
    bitwise-identical results across modes).  ``planes`` is the output of
    :func:`build_refinement_planes` (intensity data term) or None
    (Q1 magnitude levels)."""
    if planes is None:
        return variational_refinement(l1.img, l2.img, flow, cfg)
    return variational_refinement(planes[0][scale], planes[1][scale],
                                  flow, cfg, pad=0)


def dis_scale_window(l1, l2, flow_coarse, cfg: DISConfig, scale: int,
                     win_lo: int, win_hi: int):
    """One scale of the pipeline restricted to output rows
    [win_lo, win_hi): template extraction + IC-LK search for exactly the
    patches whose footprint touches the window, then densification of
    the window rows — all against FULL-frame level planes ``l1``/``l2``
    and the FULL coarser dense flow ``flow_coarse`` (None at the
    coarsest scale).

    Bitwise equal to rows [win_lo, win_hi) of the untiled scale body
    (``dis_flow_padded`` routes through this function with the full
    window): per-patch math is independent across the patch batch, and
    the densification stencil for a window row sums exactly the
    contributions the full run sums, in the same order.  This is the
    building block of the grid-tiled engine (parallel/tiles.py), which
    shards the patch grid + output rows while replicating images — the
    mode that supports per-level variational refinement (a global
    stencil between scales).

    Returns (flow_window [win_hi-win_lo, w_s, 2], geom, SearchResult).
    """
    sw, gh_s = l1.width, l1.height
    geom = make_grid(sw, gh_s, cfg.steps,
                     iy_range=window_patch_rows(cfg, gh_s, win_lo, win_hi))
    centers = jnp.asarray(geom.centers)

    tpl = iclk.extract_templates_grid(
        l1.img, l1.dx, l1.dy, geom, cfg.patch_size, cfg.img_padding)

    if flow_coarse is None:
        init_u = jnp.zeros_like(centers)
    else:
        init_u = init_from_coarser_flow(geom, flow_coarse)

    res = iclk.inverse_search(l2.img, tpl, centers, init_u, cfg, sw, gh_s)

    wts = _fixed_weights(res, tpl, cfg) if cfg.mode == "fixed" else None
    flow = densify(res.u, geom, sw, win_hi - win_lo, cfg.patch_size, wts,
                   out_row0=win_lo)
    return flow, geom, res


def dis_flow_padded(img1: jnp.ndarray, img2: jnp.ndarray,
                    cfg: DISConfig, return_debug: bool = False):
    """DIS flow on an already divisibility-padded grayscale float pair.

    Returns flow at scale ``finest_scale``:
    [H / 2**finest, W / 2**finest, 2] — the C13 upscale/crop is in
    :func:`dis_flow`.  With ``return_debug``, also returns a per-scale
    list of (scale, centers, u, level_image) for the C12 grid overlay
    (optical_flow.cpp:92-123).
    """
    h, w = img1.shape
    f = 2 ** cfg.coarsest_scale
    if w % f or h % f:
        raise ValueError(f"padded input dims must be divisible by {f}")

    with jax.named_scope("pyramid"):
        pyr1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding)
        pyr2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding)

    planes = build_refinement_planes(img1, img2, cfg)
    flow = None
    debug = []
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        with jax.named_scope(f"scale_{scale}"):
            l1 = pyr1[scale]
            l2 = pyr2[scale]
            sw, sh = l1.width, l1.height
            flow, geom, res = dis_scale_window(
                l1, l2, flow, cfg, scale, 0, sh)
            if cfg.refinement_iters > 0 and cfg.refine_per_level:
                # DIS paper sec. 3.3: refine the densified flow at every
                # scale; the refined field seeds the next-finer init.
                with jax.named_scope(f"refine_s{scale}"):
                    flow = refine_level(l1, l2, flow, cfg, scale, planes)
            if return_debug:
                p = cfg.img_padding
                debug.append((scale, geom.centers, res.u,
                              l1.img[p:p + sh, p:p + sw]))

    if cfg.refinement_iters > 0 and not cfg.refine_per_level:
        with jax.named_scope("variational_refinement"):
            s = cfg.finest_scale
            if planes is None:
                flow = variational_refinement(
                    pyr1[s].img, pyr2[s].img, flow, cfg)
            else:
                flow = variational_refinement(
                    planes[0][s], planes[1][s], flow, cfg, pad=0)
    from ..utils import checks
    if checks.enabled():
        checks.check(jnp.isfinite(flow).all(),
                     "pipeline produced non-finite flow")
    if return_debug:
        return flow, debug
    return flow


def motion_bound(cfg: DISConfig, scale: int) -> float:
    """Upper bound on |u| at ``scale`` from the policing chain: the
    coarsest init is zero and every scale adds at most ``ps/2`` on top
    of twice the coarser flow (patch.cpp:185-194 + patch_grid.cpp:116)."""
    b = cfg.outlier_thresh
    for _ in range(cfg.coarsest_scale - scale):
        b = 2.0 * b + cfg.outlier_thresh
    return b


def _stripe_plan(cfg: DISConfig, global_w: int, global_h: int,
                 own_r0: int, own_h: int):
    """Per-scale (patch-row range, flow-output window) for a stripe that
    must emit global rows [own_r0, own_r0 + own_h) at the finest scale.

    Windows propagate coarser via the nearest-neighbor init lookup
    (floor(cy/2), quirk Q8); patch ranges cover every footprint that
    touches the scale's output window.
    """
    import math as _m

    half = cfg.patch_size // 2
    steps = cfg.steps
    win = {cfg.finest_scale: (own_r0 >> cfg.finest_scale,
                              (own_r0 + own_h) >> cfg.finest_scale)}
    iy = {}
    for s in range(cfg.finest_scale, cfg.coarsest_scale + 1):
        gh_s = global_h >> s
        num_h = _m.ceil(gh_s / steps)
        offh = _m.floor((gh_s - (num_h - 1) * steps) / 2)
        lo, hi = win[s]
        cy_lo = lo - half + 1
        cy_hi = hi - 1 + half
        iy0 = max(0, _m.ceil((cy_lo - offh) / steps))
        iy1 = min(num_h, _m.floor((cy_hi - offh) / steps) + 1)
        iy[s] = (iy0, iy1)
        if s < cfg.coarsest_scale:
            cmin = iy0 * steps + offh
            cmax = (iy1 - 1) * steps + offh
            win[s + 1] = (cmin // 2, cmax // 2 + 1)
    return iy, win


def validate_stripe_geometry(cfg: DISConfig, width: int, global_h: int,
                             row0: int, ext_h: int, own_r0: int,
                             own_h: int) -> None:
    """Static check that a stripe's halo covers every included patch's
    sampling reach and stencil margins; raises ValueError otherwise."""
    import math as _m

    iy_plan, _ = _stripe_plan(cfg, width, global_h, own_r0, own_h)
    ps = cfg.patch_size
    stencil_margin = 4  # pyramid edge contamination per level (bounded)
    for s in range(cfg.finest_scale, cfg.coarsest_scale + 1):
        r0_s = row0 >> s
        eh_s = ext_h >> s
        gh_s = global_h >> s
        iy0, iy1 = iy_plan[s]
        if iy0 >= iy1:
            continue
        num_h = _m.ceil(gh_s / cfg.steps)
        offh = _m.floor((gh_s - (num_h - 1) * cfg.steps) / 2)
        cmin = iy0 * cfg.steps + offh
        cmax = (iy1 - 1) * cfg.steps + offh
        reach = motion_bound(cfg, s) + ps + 3
        lo_ok = (r0_s == 0) or (cmin - reach >= r0_s + stencil_margin)
        hi_ok = (r0_s + eh_s == gh_s) or (
            cmax + reach < r0_s + eh_s - stencil_margin)
        if not (lo_ok and hi_ok):
            raise ValueError(
                f"stripe halo too small at scale {s}: patches "
                f"[{cmin},{cmax}] need +/-{reach:.0f} rows inside "
                f"[{r0_s},{r0_s + eh_s}) of {gh_s}")


def stripe_local_signature(cfg: DISConfig, width: int, global_h: int,
                           row0: int, ext_h: int, own_r0: int,
                           own_h: int) -> tuple:
    """Localized static geometry of a stripe program: two stripes with
    EQUAL signatures run the identical static program up to the global
    row offset ``row0`` (which enters only as data — patch centers and
    sampling index arithmetic).  Captures, per scale: patch count, the
    extraction offset of the first patch row within the extended block,
    the densification window size and alignment, and the local
    coarse-init lookup rows.  Used by the tiled engine to dedupe the
    per-device ``lax.switch`` to one branch per signature group
    (interior stripes of an aligned split collapse to a single branch)."""
    import math as _m

    iy_plan, win_plan = _stripe_plan(cfg, width, global_h, own_r0, own_h)
    steps = cfg.steps
    # ext size, top-halo reach (captures frame-top clamping), and
    # whether the stripe touches the frame bottom (its pyramid border
    # then coincides with the true frame border).
    sig = (ext_h, own_r0 - row0, row0 + ext_h >= global_h, row0 == 0)
    for s in range(cfg.finest_scale, cfg.coarsest_scale + 1):
        gh_s = global_h >> s
        r0_s = row0 >> s
        iy0, iy1 = iy_plan[s]
        wlo, whi = win_plan[s]
        num_h = _m.ceil(gh_s / steps)
        offh = _m.floor((gh_s - (num_h - 1) * steps) / 2)
        c0 = iy0 * steps + offh
        entry = (iy1 - iy0, c0 - r0_s, whi - wlo, c0 - wlo, wlo - r0_s)
        if s < cfg.coarsest_scale:
            import numpy as _np
            cys = tuple(((_np.arange(iy0, iy1) * steps + offh) // 2
                         - win_plan[s + 1][0]).tolist())
            entry = entry + (cys,)
        sig = sig + (entry,)
    return sig


def dis_flow_stripe(img1_ext: jnp.ndarray, img2_ext: jnp.ndarray,
                    cfg: DISConfig, row0: int, own_r0: int, own_h: int,
                    global_h: int, row_delta=None) -> jnp.ndarray:
    """Exact tiled execution: flow for global rows
    [own_r0, own_r0 + own_h) from an extended stripe covering global
    rows [row0, row0 + ext_h).

    All geometry (patch grid, policing bounds, densification windows)
    is GLOBAL — the stripe only localizes the image planes — so interior
    results match the untiled pipeline exactly.  ``row0``, ``ext_h``,
    ``own_r0`` and ``own_h`` must be multiples of ``2**coarsest_scale``;
    the halo must cover the per-scale motion bound plus stencil margins
    (validated statically, raises ValueError otherwise).

    Variational refinement is a GLOBAL stencil and is therefore never
    applied here: the tiling layer (parallel/tiles.py) owns it — it
    refines the gathered full-frame flow (final-scale refinement), or
    routes per-level-refinement configs through the grid-tiled engine.
    ``cfg.refinement_*`` fields are ignored by this function.

    ``row_delta`` (traced int32 scalar, multiples of 2**coarsest)
    supports the deduped tiled switch: this static program — built for
    a group-representative stripe — computes a member stripe sitting
    ``row_delta`` finest-frame rows lower.  The member must have an
    EQUAL :func:`stripe_local_signature`; the offset then enters only
    integer-exact data paths (centers, sampling index arithmetic), so
    the result is bitwise what a per-stripe static program computes.
    """
    ext_h, w = img1_ext.shape
    f = 2 ** cfg.coarsest_scale
    for name, v in [("row0", row0), ("ext_h", ext_h), ("own_r0", own_r0),
                    ("own_h", own_h), ("global_h", global_h)]:
        if v % f:
            raise ValueError(f"{name}={v} must be divisible by {f}")

    iy_plan, win_plan = _stripe_plan(cfg, w, global_h, own_r0, own_h)
    validate_stripe_geometry(cfg, w, global_h, row0, ext_h, own_r0, own_h)

    with jax.named_scope("pyramid"):
        pyr1 = construct_pyramid(img1_ext, cfg.coarsest_scale,
                                 cfg.img_padding)
        pyr2 = construct_pyramid(img2_ext, cfg.coarsest_scale,
                                 cfg.img_padding)

    flow = None
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        with jax.named_scope(f"stripe_scale_{scale}"):
            l1 = pyr1[scale]
            l2 = pyr2[scale]
            sw = l1.width
            gh_s = global_h >> scale
            r0_s = row0 >> scale
            geom = make_grid(sw, gh_s, cfg.steps, iy_range=iy_plan[scale])
            centers = jnp.asarray(geom.centers)
            if row_delta is not None:
                # Deduped tiled switch: this program was built for the
                # group representative; the member stripe sits
                # ``row_delta`` finest-frame rows lower.  The offset
                # enters ONLY as data — integer-exact adds on centers
                # and sampling index arithmetic — so results are bitwise
                # what a per-stripe static program computes (patch
                # centers are integer-valued f32; their f32 add of the
                # integer delta is exact).
                d_s = jax.lax.shift_right_arithmetic(
                    jnp.int32(row_delta), scale)
                centers = centers + jnp.stack(
                    [jnp.int32(0), d_s]).astype(jnp.float32)
                r0_s = r0_s + d_s

            tpl = iclk.extract_templates_grid(
                l1.img, l1.dx, l1.dy, geom, cfg.patch_size, cfg.img_padding,
                row0=row0 >> scale)

            if flow is None:
                init_u = jnp.zeros_like(centers)
            else:
                init_u = init_from_coarser_flow(
                    geom, flow, coarse_row_offset=win_plan[scale + 1][0])

            res = iclk.inverse_search(
                l2.img, tpl, centers, init_u, cfg, sw, gh_s, row0=r0_s)

            wts = _fixed_weights(res, tpl, cfg) if cfg.mode == "fixed" else None
            wlo, whi = win_plan[scale]
            flow = densify(res.u, geom, sw, whi - wlo, cfg.patch_size, wts,
                           out_row0=wlo)

    return flow


def dis_flow(img1: jnp.ndarray, img2: jnp.ndarray,
             cfg: DISConfig = DISConfig()) -> jnp.ndarray:
    """End-to-end flow for an arbitrary-size grayscale pair.

    Applies divisibility padding (main.cpp:140-155), the pipeline, the
    finest-scale upsample (main.cpp:191-196) and the padding crop
    (main.cpp:198).  Returns [H, W, 2] at input resolution.
    """
    h, w = img1.shape
    p1, (padw, padh) = im.pad_divisible(img1.astype(jnp.float32), cfg.coarsest_scale)
    p2, _ = im.pad_divisible(img2.astype(jnp.float32), cfg.coarsest_scale)
    flow = dis_flow_padded(p1, p2, cfg)
    if cfg.finest_scale != 0:
        sc = 2 ** cfg.finest_scale
        flow = flow * jnp.float32(sc)
        flow = im.resize_bilinear(flow, p1.shape[1], p1.shape[0])
    return im.crop_padding(flow, padw, padh, w, h)


@partial(jax.jit, static_argnames=("cfg",))
def dis_flow_jit(img1: jnp.ndarray, img2: jnp.ndarray,
                 cfg: DISConfig) -> jnp.ndarray:
    return dis_flow(img1, img2, cfg)
