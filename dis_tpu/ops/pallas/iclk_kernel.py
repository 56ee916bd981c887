"""Fused IC-LK search kernel for the GPU (Pallas, Triton route).

The hot loop of DIS (patch.cpp:156-203 per patch, dispatched serially
in the reference) runs here as ONE kernel launch per scale.  Patches
never interact within a scale, so each program owns a power-of-two
block of patches and runs the whole iteration loop for them: template,
gradients, the 2x2 inverse Hessian and the state stay in registers; the
bilinear taps of every iteration are gathered straight from the padded
level plane by index arithmetic (a 1080p plane is ~8.5 MB and stays
resident in the card's L2).  No per-patch region is pre-extracted, and
the loop exits early per block once every patch in it is frozen, with
no round trip to the host.

Numerics follow ops/iclk.py::inverse_search with the direct sampler
(``sample_patches``): the ``ceil(pos + 1e-5)`` float32 tap base (Q10),
the same weight/tap pairing, the policing order (Q9) and the
``iterations + 1`` trip count (Q5).  Sums reduce in the kernel's own
order and the compiler may contract multiply-adds differently, so the
result is ulp-equivalent to the XLA search, not bitwise; a discrete
policing decision can flip on a knife edge (tests/test_pallas_iclk.py
bounds the share).

Patch-size tap counts that are not powers of two (ps=12: 144 taps) are
padded to the next power of two and masked.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...config import DISConfig

# Elements of one [patches, taps] tile per program: 32 patches x 64 taps
# at ps=8, 8 x 256 at ps=12.  With 4 warps each thread holds 16 values
# of every live tile.
_TILE = 2048
_NUM_WARPS = 4

# rows of the f32 per-patch meta array [M_ROWS, total]
M_IAA, M_IAB, M_IBB = 0, 1, 2          # inverse Hessian entries
M_IUX, M_IUY = 3, 4                    # init_u
M_CX, M_CY = 5, 6                      # patch center (unpadded coords)
M_CONV0 = 7                            # frozen at start (1.0 / 0.0)
M_YOFF = 8                             # padding - row0 (integer-valued)
M_ROWS = 9


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def search_block(ps: int) -> Tuple[int, int]:
    """(patches per program, padded tap count) for patch size ``ps``."""
    taps = _next_pow2(ps * ps)
    return max(1, _TILE // taps), taps


def _kernel(img_ref, meta_ref, t_ref, tdx_ref, tdy_ref, tn_ref,
            u_ref, q_ref, conv_ref, *,
            block: int, taps: int, nb: int, total: int, plane: int,
            tmp_h: int, tmp_w: int, n_iters: int, ps: int, pad: int,
            lb: float, ub_w: float, ub_h: float, thresh: float,
            normalize: bool, fixed: bool, conv_eps: float):
    f32 = jnp.float32
    pp = ps * ps
    half = ps // 2
    pid = pl.program_id(0)
    img_base = (pid // nb) * plane       # this block's pair's plane

    g = pid * block + jnp.arange(block)  # [B] global patch rows
    tap = jnp.arange(taps)
    tmask = (tap < pp)[None, :]          # [1, T]
    tap_c = jnp.where(tap < pp, tap, 0)
    tj = (tap_c // ps)[None, :]          # template row j
    ti = (tap_c % ps)[None, :]           # template col i
    toff = g[:, None] * taps + tap[None, :]       # [B, T]

    def load_tpl(ref):          # zero-padded to T taps by the wrapper
        return plgpu.load(ref.at[toff])

    def mrow(k):
        return plgpu.load(meta_ref.at[k * total + g])

    iaa, iab, ibb = mrow(M_IAA), mrow(M_IAB), mrow(M_IBB)
    iux, iuy = mrow(M_IUX), mrow(M_IUY)
    cx, cy = mrow(M_CX), mrow(M_CY)
    conv0 = mrow(M_CONV0)
    yoff = mrow(M_YOFF).astype(jnp.int32)
    sx = cx + iux                        # start position pos0
    sy = cy + iuy
    tdx = load_tpl(tdx_ref)
    tdy = load_tpl(tdy_ref)
    tn = load_tpl(tn_ref) if fixed else None

    def sample(px, py):
        """Bilinear warped patch [B, T] at positions px/py [B]
        (ops/iclk.py::sample_patches, tap by tap)."""
        a = px - jnp.floor(px)
        b = py - jnp.floor(py)
        w0 = ((1 - a) * (1 - b))[:, None]
        w1 = (a * (1 - b))[:, None]
        w2 = (b * (1 - a))[:, None]
        w3 = (a * b)[:, None]
        nudge = f32(1e-5)
        cpx = jnp.clip(jnp.ceil(px + nudge), -1e6, 1e6).astype(jnp.int32) + pad
        cpy = jnp.clip(jnp.ceil(py + nudge), -1e6, 1e6).astype(jnp.int32) + yoff
        r0 = (cpy - half - 1)[:, None] + tj
        c0 = (cpx - half - 1)[:, None] + ti
        r0c = jnp.clip(r0, 0, tmp_h - 1) * tmp_w + img_base
        r1c = jnp.clip(r0 + 1, 0, tmp_h - 1) * tmp_w + img_base
        c0c = jnp.clip(c0, 0, tmp_w - 1)
        c1c = jnp.clip(c0 + 1, 0, tmp_w - 1)

        def tapv(r, c):
            return plgpu.load(img_ref.at[r + c], mask=tmask, other=0.0)

        q = (w3 * tapv(r1c, c1c) + w2 * tapv(r1c, c0c)
             + w1 * tapv(r0c, c1c) + w0 * tapv(r0c, c0c))
        if normalize:
            q = q - (jnp.sum(q, axis=1, keepdims=True)
                     * f32(1.0 / pp))
            q = jnp.where(tmask, q, 0.0)
        return q

    def body(state):
        it, ux, uy, q, conv = state
        frozen = conv > 0.5
        r = q - tn if fixed else q
        rx = jnp.sum(tdx * r, axis=1)
        ry = jnp.sum(tdy * r, axis=1)
        dx = iaa * rx + iab * ry
        dy = iab * rx + ibb * ry
        ux_new = ux - dx
        uy_new = uy - dy
        px = cx + ux_new
        py = cy + uy_new
        mx = sx - px
        my = sy - py
        dist = jnp.sqrt(mx * mx + my * my)
        oob = (px < lb) | (py < lb) | (px > ub_w) | (py > ub_h)
        policed = (dist > thresh) | oob
        ux = jnp.where(frozen, ux, jnp.where(policed, iux, ux_new))
        uy = jnp.where(frozen, uy, jnp.where(policed, iuy, uy_new))
        qs = sample(cx + ux, cy + uy)
        q = jnp.where(frozen[:, None], q, qs)
        newly = (~frozen) & policed
        if fixed:
            small = jnp.sqrt(dx * dx + dy * dy) < f32(conv_eps)
            newly = newly | ((~frozen) & small)
        conv = jnp.maximum(conv, newly.astype(f32))
        return it + 1, ux, uy, q, conv

    def cond(state):
        it, _, _, _, conv = state
        return (it < n_iters) & (jnp.min(conv) < 0.5)

    # Initial resample (patch.cpp:119-154): an OOB start freezes the
    # patch with the raw template as its query (quirk, patch.cpp:136).
    q0 = jnp.where((conv0 > 0.5)[:, None], load_tpl(t_ref), sample(sx, sy))
    # Per-block early exit: once every patch of the block is frozen no
    # state can change, so stopping is output-identical to the full
    # trip count.
    _, ux, uy, q, conv = jax.lax.while_loop(
        cond, body, (jnp.int32(0), iux, iuy, q0, conv0))

    plgpu.store(u_ref.at[g], ux)
    plgpu.store(u_ref.at[total + g], uy)
    plgpu.store(q_ref.at[toff], q)
    plgpu.store(conv_ref.at[g], conv)


def _search_call(pairs: int, npad: int, img_shape, cfg: DISConfig,
                 width: int, height: int, interpret: bool, vma=frozenset()):
    """pallas_call over ``pairs`` independent (plane, patch set) pairs,
    each padded to ``npad`` patches; all pairs share one launch.  ``vma``
    (the mesh axes the inputs vary over under ``shard_map``) types the
    outputs."""
    ps = cfg.patch_size
    block, taps = search_block(ps)
    nb = npad // block
    total = pairs * npad
    tmp_h, tmp_w = img_shape
    kernel = functools.partial(
        _kernel, block=block, taps=taps, nb=nb, total=total,
        plane=tmp_h * tmp_w, tmp_h=tmp_h, tmp_w=tmp_w,
        n_iters=cfg.iterations + 1, ps=ps, pad=cfg.img_padding,
        lb=-float(ps) / 2.0, ub_w=float(width + ps // 2 - 2),
        ub_h=float(height + ps // 2 - 2), thresh=float(cfg.outlier_thresh),
        normalize=cfg.patch_normalization, fixed=cfg.mode == "fixed",
        conv_eps=cfg.conv_eps)
    f32 = jnp.float32
    return pl.pallas_call(
        kernel,
        grid=(pairs * nb,),
        out_shape=(jax.ShapeDtypeStruct((2 * total,), f32, vma=vma),
                   jax.ShapeDtypeStruct((total * taps,), f32, vma=vma),
                   jax.ShapeDtypeStruct((total,), f32, vma=vma)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="iclk_search",
    )


def inverse_search_pallas(
    img2: jnp.ndarray,                      # [Hp, Wp] padded level plane
    T: jnp.ndarray, Tdx: jnp.ndarray, Tdy: jnp.ndarray,
    Tn: jnp.ndarray,                        # [N, ps*ps] (Tn: fixed mode)
    Hinv: jnp.ndarray,                      # [N, 2, 2]
    centers: jnp.ndarray, init_u: jnp.ndarray, conv0: jnp.ndarray,
    cfg: DISConfig, width: int, height: int, row0=0,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run the fused search; returns (u [N,2], Q [N,ps*ps], conv [N]).

    ``row0`` (the stripe's first padded-plane row; may be traced) enters
    only as per-patch data, so one program serves every stripe of the
    tiled engine.  Under ``jax.vmap`` the pair batch folds into the
    launch grid (one launch for all pairs, per-pair results unchanged).
    ``interpret`` exists for the CPU tests only.
    """
    n = centers.shape[0]
    ps = cfg.patch_size
    block, taps = search_block(ps)
    npad = -(-n // block) * block

    def padn(x):
        return jnp.pad(x, [(0, npad - n)] + [(0, 0)] * (x.ndim - 1))

    yoff = jnp.broadcast_to(
        jnp.asarray(cfg.img_padding - row0, jnp.float32), (n,))
    meta = jnp.stack([
        Hinv[:, 0, 0], Hinv[:, 0, 1], Hinv[:, 1, 1],
        init_u[:, 0], init_u[:, 1], centers[:, 0], centers[:, 1],
        conv0.astype(jnp.float32), yoff,
    ], axis=0)                                      # [M_ROWS, N]
    # padded dummy patches start frozen: they never move or sample
    meta = jnp.pad(meta, [(0, 0), (0, npad - n)])
    meta = meta.at[M_CONV0].set(jnp.where(jnp.arange(npad) >= n, 1.0,
                                          meta[M_CONV0]))
    tpls = [jnp.pad(x, [(0, npad - n), (0, taps - ps * ps)])
            for x in (T, Tdx, Tdy, Tn)]
    img_shape = img2.shape

    @jax.custom_batching.custom_vmap
    def run(img, meta_p, *tpl_p):                   # leading pair axis P
        pairs = img.shape[0]
        meta_f = meta_p.transpose(1, 0, 2).reshape(-1)  # [M, P*npad]
        ins = [img.reshape(-1), meta_f, *(t.reshape(-1) for t in tpl_p)]
        # under shard_map every operand and result must vary over the
        # same mesh axes (replicated grid constants meet per-device data)
        vma = frozenset().union(*(jax.typeof(x).vma for x in ins))
        ins = [x if jax.typeof(x).vma == vma
               else jax.lax.pcast(x, tuple(vma - jax.typeof(x).vma),
                                  to="varying") for x in ins]
        u, q, conv = _search_call(pairs, npad, img_shape, cfg, width,
                                  height, interpret, vma)(*ins)
        return (u.reshape(2, pairs, npad).transpose(1, 0, 2),
                q.reshape(pairs, npad, taps),
                conv.reshape(pairs, npad))

    @run.def_vmap
    def _run_vmap(axis_size, in_batched, *args):
        # Patch blocks are independent, so a batch of pairs folds into
        # the launch grid instead of a per-pair loop of launches.
        def fold(x, b):
            if not b:
                x = jnp.broadcast_to(x[None], (axis_size,) + x.shape)
            return x.reshape((axis_size * x.shape[1],) + x.shape[2:])

        outs = run(*(fold(x, b) for x, b in zip(args, in_batched)))
        return (tuple(o.reshape((axis_size, -1) + o.shape[1:]) for o in outs),
                (True, True, True))

    u, q, conv = run(img2[None], meta[None], *(t[None] for t in tpls))
    return u[0, :, :n].T, q[0, :n, :ps * ps], conv[0, :n] > 0.5
