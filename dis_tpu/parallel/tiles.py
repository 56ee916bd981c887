"""Exact spatial frame tiling with halo exchange (latency-oriented).

BASELINE.json config #4: one large frame split row-wise across chips.
Each device owns a horizontal stripe; the surrounding halo band is
fetched from neighbors over ICI and the stripe is computed with the
GLOBAL-geometry engine (:func:`dis_tpu.models.dis.dis_flow_stripe`), so
the stitched result equals the untiled pipeline **everywhere** — no
seam band, no local-grid approximation (tests/test_parallel.py asserts
full equality at atol 1e-5).

Design: per-stripe geometry (patch-row ranges, densification windows,
policing bounds) is static but differs per device, so the single-trace
SPMD program is a ``lax.switch`` over ``axis_index`` with one
statically-specialized branch per stripe — each branch is exactly the
program :func:`tiled_flow_exact` would run for that stripe.  All
branches return the same ``[own_h >> finest, W >> finest, 2]`` window.
Halo movement is two ``ppermute`` shifts when the required halo fits in
one neighbor stripe, or a tiled ``all_gather`` otherwise (tiny frames /
many devices); both are pure ICI traffic.

Variational refinement is a global stencil: when enabled, stripes are
computed without it, the flow is ``all_gather``-ed, refined on the full
frame exactly as the untiled pipeline does, and each device keeps its
own rows.  (Reference analogue of the data being tiled: the whole-frame
arrays ``/root/reference/src/main.cpp:162-174``.)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

import numpy as np

from ..config import DISConfig
from ..models.dis import (dis_flow_stripe, dis_scale_window, refine_level,
                          stripe_local_signature, validate_stripe_geometry)


def exchange_halo(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Extend a local row-stripe [Hl, W] with neighbors' edge bands.

    Boundary devices replicate their own edge rows; the replicated fill
    is statically sliced off by the stripe branches (frame-edge stripes
    use the true frame boundary), so fill values are never read.
    Two ``ppermute`` shifts over the mesh axis — pure ICI traffic.
    Requires ``halo <= Hl`` (one-neighbor reach).
    """
    n = lax.axis_size(axis_name)
    i = lax.axis_index(axis_name)
    top_band = x[:halo]        # my top rows -> neighbor below
    bot_band = x[-halo:]       # my bottom rows -> neighbor above
    # receive from above: their bottom band
    from_above = lax.ppermute(bot_band, axis_name,
                              [(j, j + 1) for j in range(n - 1)])
    # receive from below: their top band
    from_below = lax.ppermute(top_band, axis_name,
                              [(j + 1, j) for j in range(n - 1)])
    # boundary devices: fill (sliced off statically by the edge branches)
    top_fill = jnp.broadcast_to(x[:1], (halo,) + x.shape[1:])
    bot_fill = jnp.broadcast_to(x[-1:], (halo,) + x.shape[1:])
    top = jnp.where(i == 0, top_fill, from_above)
    bot = jnp.where(i == n - 1, bot_fill, from_below)
    return jnp.concatenate([top, x, bot], axis=0)


def stripe_bounds(cfg: DISConfig, height: int, n: int, idx: int,
                  halo: int):
    """(row0, ext_h, own_r0, own_h) for stripe ``idx`` of ``n`` with the
    given halo, clamped at frame edges; all multiples of 2**coarsest."""
    f = 2 ** cfg.coarsest_scale
    own_h = height // n
    own_r0 = idx * own_h
    row0 = max(0, own_r0 - halo)
    ext_hi = min(height, own_r0 + own_h + halo)
    return row0, ext_hi - row0, own_r0, own_h


def min_stripe_halo(cfg: DISConfig, width: int, height: int, n: int) -> int:
    """Smallest halo (multiple of 2**coarsest) for which every stripe of
    an n-way split passes the exact-tiling static validation.

    Dominated by the coarsest scale: a ``ps``-pixel patch there spans
    ``ps * 2**coarsest`` finest-level rows, so exact tiling duplicates a
    substantial band (the cost of the reference's coarse-to-fine
    locality).
    """
    f = 2 ** cfg.coarsest_scale
    for halo in range(f, height + f, f):
        try:
            for i in range(n):
                row0, ext_h, own_r0, own_h = stripe_bounds(
                    cfg, height, n, i, halo)
                validate_stripe_geometry(cfg, width, height, row0, ext_h,
                                         own_r0, own_h)
            return halo
        except ValueError:
            continue
    raise ValueError(f"no viable halo for {n} stripes of height {height}")


def _refine_full(img1: jnp.ndarray, img2: jnp.ndarray, flow: jnp.ndarray,
                 cfg: DISConfig) -> jnp.ndarray:
    """Full-frame variational refinement exactly as ``dis_flow_padded``
    runs it: on the finest-scale pyramid images (quirk-Q1 planes), or on
    the intensity chain when ``cfg.refinement_planes == "intensity"``."""
    from ..models.dis import build_refinement_planes
    from ..ops.pyramid import construct_pyramid
    from ..ops.variational import variational_refinement

    s = cfg.finest_scale
    planes = build_refinement_planes(img1, img2, cfg)
    if planes is not None:
        return variational_refinement(planes[0][s], planes[1][s], flow,
                                      cfg, pad=0)
    pyr1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding)
    pyr2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding)
    return variational_refinement(pyr1[s].img, pyr2[s].img, flow, cfg)


def window_partition(gh: int, n: int):
    """Partition ``gh`` rows into ``n`` contiguous windows as evenly as
    possible (first ``gh % n`` windows get one extra row).  Ragged
    windows are fine for :func:`dis_scale_window` — it takes arbitrary
    [lo, hi) — so the grid-tiled engines support ANY ``n`` dividing the
    output height, not just ``height % (n * 2**coarsest) == 0`` (at
    1080p that constraint admitted only n=3 of the practical sizes)."""
    base, rem = divmod(gh, n)
    out, lo = [], 0
    for i in range(n):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def grid_tiled_flow(img1: jnp.ndarray, img2: jnp.ndarray, cfg: DISConfig,
                    n_parts: int) -> jnp.ndarray:
    """EXACT grid-tiled execution on one controller: images stay whole,
    the PATCH GRID and densified output rows are split ``n_parts``-ways
    per scale (:func:`dis_tpu.models.dis.dis_scale_window`), the parts
    are concatenated, and per-level refinement (when configured) runs on
    the assembled full-frame flow exactly as ``dis_flow_padded`` does.

    This is the tiling mode that supports ``refine_per_level=True``
    (round-2 VERDICT item #1): refinement is a global stencil between
    scales, so the refined field must be assembled before it seeds the
    next-finer init — sharding the search (the dominant cost) while
    replicating the cheap global steps.  Output is bitwise equal to the
    untiled pipeline (tests/test_parallel.py).
    """
    h, w = img1.shape
    if (h >> cfg.finest_scale) < n_parts:
        raise ValueError(f"cannot split {h >> cfg.finest_scale} output "
                         f"rows into {n_parts} parts")
    from ..models.dis import build_refinement_planes
    from ..ops.pyramid import construct_pyramid
    from ..ops.variational import variational_refinement

    pyr1 = construct_pyramid(img1, cfg.coarsest_scale, cfg.img_padding)
    pyr2 = construct_pyramid(img2, cfg.coarsest_scale, cfg.img_padding)
    planes = build_refinement_planes(img1, img2, cfg)
    flow = None
    for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        l1, l2 = pyr1[scale], pyr2[scale]
        gh_s = h >> scale
        parts = [dis_scale_window(l1, l2, flow, cfg, scale, lo, hi)[0]
                 for (lo, hi) in window_partition(gh_s, n_parts)]
        flow = jnp.concatenate(parts, axis=0)
        if cfg.refinement_iters > 0 and cfg.refine_per_level:
            flow = refine_level(l1, l2, flow, cfg, scale, planes)
    if cfg.refinement_iters > 0 and not cfg.refine_per_level:
        s = cfg.finest_scale
        if planes is not None:
            flow = variational_refinement(planes[0][s], planes[1][s],
                                          flow, cfg, pad=0)
        else:
            flow = variational_refinement(pyr1[s].img, pyr2[s].img,
                                          flow, cfg)
    return flow


def tiled_flow_exact(img1: jnp.ndarray, img2: jnp.ndarray, cfg: DISConfig,
                     n_stripes: int, halo: int, refine: bool = None):
    """EXACT tiled execution on one controller: compute the frame as
    ``n_stripes`` stripes via :func:`dis_flow_stripe` and concatenate —
    every row matches the untiled pipeline (tests/test_stripe_exact.py).

    ``refine`` (default: ``cfg.refinement_iters > 0``) runs variational
    refinement on the gathered flow, matching ``dis_flow_padded``; with
    ``refine_per_level=True`` the whole computation routes through the
    grid-tiled engine instead (refinement between scales is a global
    stencil, so stripes with private image halos cannot interleave it).
    This is the host-level pattern for multi-host deployments (each host
    traces its own stripe program); :func:`tiled_flow_fn` is the
    single-trace multi-device version of the same math.
    """
    if refine is None:
        refine = cfg.refinement_iters > 0
    if refine and cfg.refinement_iters > 0 and cfg.refine_per_level:
        return grid_tiled_flow(img1, img2, cfg, n_stripes)
    h, w = img1.shape
    outs = []
    for i in range(n_stripes):
        row0, ext_h, own_r0, own_h = stripe_bounds(cfg, h, n_stripes, i, halo)
        outs.append(dis_flow_stripe(
            img1[row0:row0 + ext_h], img2[row0:row0 + ext_h], cfg,
            row0=row0, own_r0=own_r0, own_h=own_h, global_h=h))
    flow = jnp.concatenate(outs, axis=0)
    if refine and cfg.refinement_iters > 0:
        flow = _refine_full(img1, img2, flow, cfg)
    return flow


def grid_tiled_flow_fn(cfg: DISConfig, mesh: Mesh, height: int, width: int,
                       axis: str = "space"):
    """Single-trace SPMD grid-tiled engine: the multi-device version of
    :func:`grid_tiled_flow` (per-level-refinement-capable tiling).

    Images are replicated per device with one entry ``all_gather``; per
    scale, each device searches + densifies only its ``gh_s / n`` output
    rows (a ``lax.switch`` over per-device window programs — total
    program size is O(1) in n: each branch holds ~1/n of the scale's
    patches), the row partitions are ``all_gather``-ed into the full
    flow, and refinement runs replicated on the full frame exactly as
    the untiled pipeline.  Output equals ``dis_flow_padded`` everywhere.
    """
    from ..ops.pyramid import construct_pyramid
    from ..ops.variational import variational_refinement

    n = mesh.shape[axis]
    if height % n:
        raise ValueError(
            f"height {height} must be divisible by n_space={n} "
            "(equal image input shards)")
    if (height >> cfg.finest_scale) % n:
        raise ValueError(
            f"output height {height >> cfg.finest_scale} must be "
            f"divisible by n_space={n} (equal output shards)")

    def local(i1, i2):
        from ..models.dis import build_refinement_planes

        idx = lax.axis_index(axis)
        f1 = lax.all_gather(i1, axis, axis=0, tiled=True)
        f2 = lax.all_gather(i2, axis, axis=0, tiled=True)
        pyr1 = construct_pyramid(f1, cfg.coarsest_scale, cfg.img_padding)
        pyr2 = construct_pyramid(f2, cfg.coarsest_scale, cfg.img_padding)
        planes = build_refinement_planes(f1, f2, cfg)
        flow = None
        for scale in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
            l1, l2 = pyr1[scale], pyr2[scale]
            gh_s = height >> scale
            wins = window_partition(gh_s, n)
            cmax = wins[0][1] - wins[0][0]   # first window is the largest
            fc = flow

            def make_branch(lo, hi, l1=l1, l2=l2, fc=fc, scale=scale,
                            cmax=cmax):
                def branch(_):
                    part = dis_scale_window(l1, l2, fc, cfg, scale,
                                            lo, hi)[0]
                    if hi - lo < cmax:   # ragged: pad for the equal-
                        part = jnp.pad(  # shard all_gather, drop below
                            part, ((0, cmax - (hi - lo)), (0, 0), (0, 0)))
                    return part
                return branch

            part = lax.switch(
                idx, [make_branch(lo, hi) for (lo, hi) in wins], ())
            flow = lax.all_gather(part, axis, axis=0, tiled=True)
            if gh_s != n * cmax:   # drop the ragged padding rows
                flow = jnp.concatenate(
                    [lax.slice_in_dim(flow, i * cmax, i * cmax + (hi - lo),
                                      axis=0)
                     for i, (lo, hi) in enumerate(wins)], axis=0)
            if cfg.refinement_iters > 0 and cfg.refine_per_level:
                flow = refine_level(l1, l2, flow, cfg, scale, planes)
        if cfg.refinement_iters > 0 and not cfg.refine_per_level:
            s = cfg.finest_scale
            if planes is not None:
                flow = variational_refinement(planes[0][s], planes[1][s],
                                              flow, cfg, pad=0)
            else:
                flow = variational_refinement(pyr1[s].img, pyr2[s].img,
                                              flow, cfg)
        fs = cfg.finest_scale
        own = (height >> fs) // n
        return lax.dynamic_slice_in_dim(flow, idx * own, own, axis=0)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=P(axis, None, None),
    )
    return jax.jit(fn)


def tiled_flow_fn(cfg: DISConfig, mesh: Mesh, height: int, width: int,
                  axis: str = "space", halo: int = None):
    """Returns a jitted fn ([H, W], [H, W]) -> [H/2**finest, W/2**finest, 2]
    with the frame row-sharded over ``axis`` — output EQUAL to
    ``dis_flow_padded`` everywhere (exact tiling, no seam band).

    ``height`` must be divisible by ``axis_size * 2**coarsest_scale``.
    ``halo`` defaults to :func:`min_stripe_halo` (validated otherwise).
    Per-level-refinement configs (DIS_MEDIUM/DIS_FULL) route through the
    grid-tiled engine (:func:`grid_tiled_flow_fn`): refinement between
    scales is a global stencil, incompatible with private image halos.
    """
    n = mesh.shape[axis]
    f = 2 ** cfg.coarsest_scale
    if cfg.refinement_iters > 0 and cfg.refine_per_level:
        return grid_tiled_flow_fn(cfg, mesh, height, width, axis=axis)
    if height % (n * f):
        raise ValueError(
            f"height {height} must be divisible by n_space*{f} = {n * f} "
            "for stripe tiling (aligned equal stripes); use "
            "grid_tiled_flow_fn for other splits")
    own_h = height // n
    if halo is None:
        halo = min_stripe_halo(cfg, width, height, n)
    else:
        for i in range(n):
            row0, ext_h, own_r0, oh = stripe_bounds(cfg, height, n, i, halo)
            validate_stripe_geometry(cfg, width, height, row0, ext_h,
                                     own_r0, oh)
    # One ppermute hop reaches one neighbor stripe; larger halos (tiny
    # frames / many devices) fall back to a tiled all_gather.
    use_gather = halo > own_h
    base_cfg = dataclasses.replace(cfg, refinement_iters=0)

    # Dedupe the per-device switch (round-2 VERDICT item #4): stripes
    # whose LOCALIZED static geometry is identical (interior stripes of
    # an aligned split — everything but the global row offset, which is
    # pure data) share ONE branch, with the member's row offset passed
    # as a traced delta.  Branch count is then O(1) in n for aligned
    # splits (top / interiors / bottom) instead of n full pipelines.
    # Results stay bitwise: the delta enters only integer-exact adds
    # (dis_flow_stripe row_delta note).  In gather mode the block-row
    # origin b0 is absolute, so every stripe keeps its own branch.
    bounds = [stripe_bounds(cfg, height, n, i, halo) for i in range(n)]
    sigs = []
    import os as _os
    dedupe = _os.environ.get("DIS_TPU_TILE_DEDUPE", "1") == "1"
    for i in range(n):
        row0, ext_h, own_r0, _ = bounds[i]
        b0 = row0 if use_gather else row0 - (own_r0 - halo)
        if dedupe:
            sigs.append((b0,) + stripe_local_signature(
                cfg, width, height, row0, ext_h, own_r0, own_h))
        else:
            # DIS_TPU_TILE_DEDUPE=0: unique key per stripe (A/B and
            # debugging — one full branch per device, round-2 shape).
            sigs.append((b0, i))
    group_rep = {}          # signature -> representative stripe index
    group_of = []           # stripe -> group id
    reps = []               # group id -> representative stripe index
    for i in range(n):
        key = sigs[i]
        if key not in group_rep:
            group_rep[key] = len(reps)
            reps.append(i)
        group_of.append(group_rep[key])

    def make_branch(rep_i):
        row0, ext_h, own_r0, _ = bounds[rep_i]
        # Row of the extended block holding global row row0.
        b0 = row0 if use_gather else row0 - (own_r0 - halo)

        def branch(ops):
            e1, e2, delta = ops
            s1 = lax.slice_in_dim(e1, b0, b0 + ext_h, axis=0)
            s2 = lax.slice_in_dim(e2, b0, b0 + ext_h, axis=0)
            return dis_flow_stripe(s1, s2, base_cfg, row0=row0,
                                   own_r0=own_r0, own_h=own_h,
                                   global_h=height, row_delta=delta)
        return branch

    branches = [make_branch(r) for r in reps]
    group_table = np.asarray(group_of, np.int32)
    rep_row0 = np.asarray([bounds[r][0] for r in reps], np.int32)
    row0_table = np.asarray([b[0] for b in bounds], np.int32)

    def local(i1, i2):
        if use_gather:
            e1 = lax.all_gather(i1, axis, axis=0, tiled=True)
            e2 = lax.all_gather(i2, axis, axis=0, tiled=True)
        else:
            e1 = exchange_halo(i1, halo, axis)
            e2 = exchange_halo(i2, halo, axis)
        idx = lax.axis_index(axis)
        gid = jnp.take(jnp.asarray(group_table), idx)
        delta = (jnp.take(jnp.asarray(row0_table), idx)
                 - jnp.take(jnp.asarray(rep_row0), gid))
        flow = lax.switch(gid, branches, (e1, e2, delta))
        if cfg.refinement_iters > 0:
            # Global stencil: gather, refine the full frame exactly as
            # the untiled pipeline, keep own rows.
            fs = cfg.finest_scale
            flow_full = lax.all_gather(flow, axis, axis=0, tiled=True)
            if use_gather:
                f1, f2 = e1, e2
            else:
                f1 = lax.all_gather(i1, axis, axis=0, tiled=True)
                f2 = lax.all_gather(i2, axis, axis=0, tiled=True)
            flow_full = _refine_full(f1, f2, flow_full, cfg)
            flow = lax.dynamic_slice_in_dim(
                flow_full, idx * (own_h >> fs), own_h >> fs, axis=0)
        return flow

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=P(axis, None, None),
    )
    return jax.jit(fn)
