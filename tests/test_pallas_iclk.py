"""Pallas-Triton IC-LK search kernel vs the XLA search (interpret mode).

The kernel gathers its bilinear taps straight from the level plane, so
its reference is the XLA search with the direct sampler
(``sampler="global"``).  Sums reduce in another order and multiply-adds
may contract differently, so the gate is the equivalence class: final
``u`` to 1e-3 and a bounded share of freeze flips.  Properties that
involve no change of arithmetic (ragged patch counts, the pair fold
under vmap, the per-block early exit) are gated bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dis_tpu.config import DISConfig
from dis_tpu.ops import iclk
from dis_tpu.ops.grid import make_grid
from dis_tpu.ops.pallas.iclk_kernel import inverse_search_pallas, search_block
from dis_tpu.ops.pyramid import construct_pyramid

from conftest import synthetic_pair


def _problem(mode, ps=8, seed=9, h=40, w=56, **kw):
    i1, i2 = synthetic_pair(h, w, shift=(2.0, 1.0), seed=seed)
    cfg = DISConfig(iterations=6, patch_size=ps, coarsest_scale=0,
                    patch_overlap=0.5, mode=mode, kernel="xla",
                    sampler="global", **kw)
    l1 = construct_pyramid(jnp.asarray(i1), 0, cfg.img_padding)[0]
    l2 = construct_pyramid(jnp.asarray(i2), 0, cfg.img_padding)[0]
    centers = jnp.asarray(make_grid(l1.width, l1.height, cfg.steps).centers)
    tpl = iclk.extract_templates(l1.img, l1.dx, l1.dy, centers, ps,
                                 cfg.img_padding)
    init_u = jnp.asarray(np.random.default_rng(seed).uniform(
        -2, 2, centers.shape).astype(np.float32))
    return cfg, l1, l2, tpl, centers, init_u


def _kernel(cfg, l1, l2, tpl, centers, init_u, row0=0):
    ps = cfg.patch_size
    Tn = tpl.T
    if cfg.mode == "fixed" and cfg.patch_normalization:
        Tn = tpl.T - iclk.pairwise_sum(tpl.T)[:, None] * jnp.float32(
            1.0 / (ps * ps))
    pos0 = centers + init_u
    lb = -ps / 2
    conv0 = ((pos0[:, 0] < lb) | (pos0[:, 1] < lb)
             | (pos0[:, 0] > l1.width + ps // 2 - 2)
             | (pos0[:, 1] > l1.height + ps // 2 - 2))
    return inverse_search_pallas(
        l2.img, tpl.T, tpl.Tdx, tpl.Tdy, Tn, tpl.Hinv, centers, init_u,
        conv0, cfg, l1.width, l1.height, row0=row0, interpret=True)


@pytest.mark.parametrize("ps", [8, 12])
@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_kernel_matches_xla_search(mode, ps):
    cfg, l1, l2, tpl, centers, init_u = _problem(mode, ps)
    want = iclk.inverse_search(l2.img, tpl, centers, init_u, cfg,
                               l1.width, l1.height)
    u, q, conv = _kernel(cfg, l1, l2, tpl, centers, init_u)
    assert u.shape == want.u.shape and q.shape == want.Q.shape
    du = np.abs(np.asarray(u) - np.asarray(want.u))
    assert du.max() < 1e-3, du.max()
    flips = (np.asarray(conv) != np.asarray(want.converged)).mean()
    assert flips < 0.02, flips
    # Q10 addresses taps from ceil(pos + 1e-5): a patch whose final
    # position sits within ~1e-5 of an integer may sample ADJACENT
    # texels across the two searches when their u differ by ulps —
    # exclude those knife-edge patches from the Q comparison.
    pos = np.asarray(centers) + np.asarray(want.u)
    edge = (np.abs(pos - np.round(pos)) < 2e-5).any(axis=1)
    np.testing.assert_allclose(np.asarray(q)[~edge],
                               np.asarray(want.Q)[~edge], atol=1e-2)


def test_ragged_patch_count_is_per_patch():
    """A patch count that is not a block multiple pads with frozen dummy
    patches; every real patch's result is independent of its block."""
    cfg, l1, l2, tpl, centers, init_u = _problem("fixed")
    block, _ = search_block(cfg.patch_size)
    n = block + 5
    assert centers.shape[0] > n
    full = _kernel(cfg, l1, l2, tpl, centers, init_u)
    sub = _kernel(cfg, l1, l2, jax.tree.map(lambda x: x[:n], tpl),
                  centers[:n], init_u[:n])
    for a, b in zip(sub, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b)[:n])


def test_vmap_folds_pairs_into_one_launch():
    """jax.vmap over pairs folds the batch into the launch grid (one
    pallas_call) and equals per-pair runs bitwise."""
    cfg, l1, l2, tpl, centers, init_u = _problem("compat")
    _, _, l2b, tplb, _, init_b = _problem("compat", seed=4)
    imgs = jnp.stack([l2.img, l2b.img])
    tpls = jax.tree.map(lambda a, b: jnp.stack([a, b]), tpl, tplb)
    inits = jnp.stack([init_u, init_b])

    def f(img, t, iu):
        l2x = l2._replace(img=img)
        return _kernel(cfg, l1, l2x, t, centers, iu)

    jaxpr = jax.make_jaxpr(jax.vmap(f))(imgs, tpls, inits)
    assert str(jaxpr).count("pallas_call") == 1
    batched = jax.vmap(f)(imgs, tpls, inits)
    for k in range(2):
        serial = f(imgs[k], jax.tree.map(lambda x: x[k], tpls), inits[k])
        for got, want in zip(batched, serial):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want))


def test_early_exit_per_block():
    """Once every patch of a block is frozen the loop stops: a run with
    300 iterations in which every patch converges at its first step
    equals the one-iteration run bitwise."""
    cfg, l1, l2, tpl, centers, init_u = _problem("fixed", conv_eps=1e3)
    long = _kernel(dataclasses.replace(cfg, iterations=300), l1, l2, tpl,
                   centers, init_u)
    short = _kernel(dataclasses.replace(cfg, iterations=1), l1, l2, tpl,
                    centers, init_u)
    assert bool(np.asarray(long[2]).all())
    for a, b in zip(long, short):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_traced_row0_matches_static():
    """The stripe offset ``row0`` enters as per-patch data, so a traced
    row0 (the tiled engine's deduped switch) equals a static one."""
    cfg, l1, l2, tpl, centers, init_u = _problem("compat")
    static = _kernel(cfg, l1, l2, tpl, centers, init_u, row0=3)
    traced = jax.jit(lambda r: _kernel(cfg, l1, l2, tpl, centers, init_u,
                                       row0=r))(jnp.int32(3))
    for a, b in zip(traced, static):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
