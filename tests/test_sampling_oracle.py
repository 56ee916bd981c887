"""IC-LK query sampling: the region route and the direct gather both
against the NumPy oracle of patch.cpp:207-267 (Q10 ceil tap base), at
the patch sizes of the presets."""

import jax.numpy as jnp
import numpy as np
import pytest

from dis_tpu.oracle import reference_semantics as ref
from dis_tpu.ops import iclk


@pytest.mark.parametrize("ps", [8, 12])
def test_region_and_direct_sampling_match_oracle(ps):
    rng = np.random.default_rng(ps)
    pad = ps
    img = (rng.random((80, 112)) * 255).astype(np.float32)  # padded plane
    h, w = 80 - 2 * pad, 112 - 2 * pad
    n = 64
    # start positions inside the frame, as the pipeline's grid has them
    p0 = (rng.random((n, 2)) * np.array([w - ps, h - ps])
          + ps / 2).astype(np.float32)
    regions, by, bx = iclk.extract_regions(jnp.asarray(img), jnp.asarray(p0),
                                           ps, pad)
    for trial in range(3):
        # positions the search can produce: within ps/2 of the start
        d = ((rng.random((n, 2)) * 2 - 1) * (ps / 2 - 0.2) / np.sqrt(2))
        pos = (p0 + d).astype(np.float32)
        for normalize in (False, True):
            want = ref.sample_patches(img, pos, ps, pad, img.shape[1],
                                      normalize)
            direct = iclk.sample_patches(jnp.asarray(img), jnp.asarray(pos),
                                         ps, pad, normalize)
            region = iclk.sample_from_regions(regions, by, bx,
                                              jnp.asarray(pos), ps, pad,
                                              normalize)
            np.testing.assert_allclose(np.asarray(direct), want, atol=1e-3)
            np.testing.assert_allclose(np.asarray(region), want, atol=2e-3)
