"""Region-based sampler vs global sampler: exact-path equivalence.

The region sampler (per-patch regions + one-hot contractions) must
match the
reference-shaped global sampler for all positions the search can
legally produce (within ``ps/2`` of the region's start position).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dis_tpu.config import DISConfig
from dis_tpu.models.dis import dis_flow_padded
from dis_tpu.ops import iclk

from conftest import synthetic_pair


def test_sample_from_regions_matches_global(rng):
    ps, pad = 8, 8
    img = jnp.asarray((rng.random((80, 96)) * 255).astype(np.float32))
    n = 40
    # start positions away from edges; offsets within the policing ball
    p0 = (rng.random((n, 2)) * np.array([60, 44]) + 2).astype(np.float32)
    regions, by, bx = iclk.extract_regions(img, jnp.asarray(p0), ps, pad)
    for trial in range(4):
        # random offset with |d| <= 4 (euclidean)
        d = (rng.random((n, 2)) * 2 - 1) * 2.8
        pos = jnp.asarray(p0 + d.astype(np.float32))
        want = iclk.sample_patches(img, pos, ps, pad, True)
        got = iclk.sample_from_regions(regions, by, bx, pos, ps, pad, True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=2e-3)


def test_sample_from_regions_integer_positions(rng):
    ps, pad = 8, 8
    img = jnp.asarray((rng.random((64, 64)) * 255).astype(np.float32))
    p0 = np.array([[10.0, 12.0], [31.0, 7.0], [20.0, 20.0]], np.float32)
    regions, by, bx = iclk.extract_regions(img, jnp.asarray(p0), ps, pad)
    for d in ([0.0, 0.0], [4.0, 0.0], [-4.0, 0.0], [0.0, -4.0], [2.0, -2.0]):
        pos = jnp.asarray(p0 + np.float32(d))
        want = iclk.sample_patches(img, pos, ps, pad, False)
        got = iclk.sample_from_regions(regions, by, bx, pos, ps, pad, False)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-3)


@pytest.mark.parametrize("mode", ["compat", "fixed"])
def test_e2e_region_equals_global(small_pair, mode):
    i1, i2 = small_pair
    kw = dict(iterations=10, coarsest_scale=2, patch_overlap=0.5,
              early_exit=False, mode=mode)
    f_region = np.asarray(dis_flow_padded(
        jnp.asarray(i1), jnp.asarray(i2), DISConfig(sampler="region", **kw)))
    f_global = np.asarray(dis_flow_padded(
        jnp.asarray(i1), jnp.asarray(i2), DISConfig(sampler="global", **kw)))
    np.testing.assert_allclose(f_region, f_global, atol=5e-2)
    # and the bulk of the field should be essentially identical
    assert np.median(np.abs(f_region - f_global)) < 1e-4
