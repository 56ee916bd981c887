"""The XLA pyramid (the one implementation on every platform) against
the NumPy oracle of main.cpp:12-50, at the patch sizes and frame shapes
the pipeline uses, plus its bitwise properties: jit == chained levels,
and vmap == serial."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dis_tpu.oracle import reference_semantics as ref
from dis_tpu.ops import image as im
from dis_tpu.ops.pyramid import construct_pyramid

# f32 Sobel/magnitude/2x2-mean chains: the compiled program may contract
# multiply-adds and reassociate the 2x2 mean, the oracle does neither.
RTOL, ATOL = 1e-5, 1e-3


def _img(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _check(levels, want, coarsest):
    w_img, w_dx, w_dy = want
    assert len(levels) == coarsest + 1
    for s, lv in enumerate(levels):
        for got, exp in ((lv.img, w_img[s]), (lv.dx, w_dx[s]),
                         (lv.dy, w_dy[s])):
            assert got.shape == exp.shape
            np.testing.assert_allclose(np.asarray(got), exp, rtol=RTOL,
                                       atol=ATOL, err_msg=f"scale {s}")


@pytest.mark.parametrize("shape", [(64, 96), (72, 496), (56, 128)])
@pytest.mark.parametrize("p", [8, 12])
def test_levels_match_oracle(shape, p):
    raw = _img(shape, 1)
    got = jax.jit(lambda x: construct_pyramid(x, 2, p))(jnp.asarray(raw))
    _check(got, ref.construct_pyramid(raw, 2, p), 2)


@pytest.mark.parametrize("shape", [(64, 96), (72, 496)])
def test_base_level_matches_oracle(shape):
    """Level 0 is the gradient magnitude (quirk Q1) with its own Sobel
    pair, replicate/zero padded."""
    raw = _img(shape, 2)
    got = jax.jit(lambda x: construct_pyramid(x, 0, 8))(jnp.asarray(raw))
    _check(got, ref.construct_pyramid(raw, 0, 8), 0)


def test_four_level_chain_matches_oracle():
    raw = _img((128, 192), 3)
    got = jax.jit(lambda x: construct_pyramid(x, 3, 8))(jnp.asarray(raw))
    _check(got, ref.construct_pyramid(raw, 3, 8), 3)


@pytest.mark.parametrize("coarsest", [0, 2])
def test_vmap_equals_serial(coarsest):
    """Batched pairs build their pyramids with the same arithmetic as a
    single pair: jit(vmap) equals jit per example."""
    imgs = jnp.stack([jnp.asarray(_img((56, 72), s)) for s in (3, 4, 5)])
    fn = lambda x: [(l.img, l.dx, l.dy)
                    for l in construct_pyramid(x, coarsest, 8)]
    batched = jax.jit(jax.vmap(fn))(imgs)
    serial_fn = jax.jit(fn)
    for b in range(3):
        for got, want in zip(batched, serial_fn(imgs[b])):
            for g, w in zip(got, want):
                np.testing.assert_allclose(np.asarray(g[b]), np.asarray(w),
                                           rtol=RTOL, atol=ATOL)


def test_resize_half_forms_agree(monkeypatch):
    """The selectable 2x2-mean forms agree on values (bit-identical for
    these inputs; the platform picks one in dis_tpu/backend.py)."""
    x = jnp.asarray(_img((48, 80), 6))
    out = {}
    for mode in ("reshape", "window", "window2", "slices"):
        monkeypatch.setenv("DIS_TPU_RESIZE", mode)
        out[mode] = np.asarray(jax.jit(im.resize_half)(x))
    np.testing.assert_allclose(out["reshape"], ref.resize_half(np.asarray(x)),
                               rtol=RTOL)
    for mode in ("window", "window2", "slices"):
        np.testing.assert_array_equal(out[mode], out["reshape"])
