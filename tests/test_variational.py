"""Variational refinement: improves flow and respects the energy model."""

import numpy as np
import jax.numpy as jnp
import pytest

from dis_tpu.config import DISConfig
from dis_tpu.models.dis import dis_flow_padded
from dis_tpu.utils.metrics import epe

from conftest import synthetic_pair


def test_refinement_improves_subpixel_epe():
    i1, i2 = synthetic_pair(48, 64, shift=(1.5, 0.5), seed=21)
    gt = np.zeros((48, 64, 2), np.float32)
    gt[..., 0] = 1.5
    gt[..., 1] = 0.5
    base_cfg = DISConfig(iterations=20, coarsest_scale=2, patch_overlap=0.5,
                         mode="fixed", refinement_iters=0)
    ref_cfg = DISConfig(iterations=20, coarsest_scale=2, patch_overlap=0.5,
                        mode="fixed", refinement_iters=5)
    f0 = np.asarray(dis_flow_padded(jnp.asarray(i1), jnp.asarray(i2), base_cfg))
    f1 = np.asarray(dis_flow_padded(jnp.asarray(i1), jnp.asarray(i2), ref_cfg))
    # compare away from borders
    e0 = epe(f0[8:-8, 8:-8], gt[8:-8, 8:-8])
    e1 = epe(f1[8:-8, 8:-8], gt[8:-8, 8:-8])
    assert np.isfinite(e1)
    assert e1 <= e0 + 0.02, (e0, e1)


def test_refinement_preserves_constant_flow():
    # On a perfectly matched constant-shift pair, refinement should not
    # push an already-correct flow far from the truth.
    i1, i2 = synthetic_pair(40, 48, shift=(2.0, 1.0), seed=5)
    cfg = DISConfig(iterations=20, coarsest_scale=2, patch_overlap=0.5,
                    mode="fixed", refinement_iters=8)
    f = np.asarray(dis_flow_padded(jnp.asarray(i1), jnp.asarray(i2), cfg))
    med = np.median(f[10:-10, 10:-10].reshape(-1, 2), axis=0)
    assert abs(med[0] - 2.0) < 0.5 and abs(med[1] - 1.0) < 0.5, med


def test_refinement_no_nans_on_flat_image():
    flat1 = np.full((32, 32), 128.0, np.float32)
    flat2 = np.full((32, 32), 128.0, np.float32)
    cfg = DISConfig(iterations=4, coarsest_scale=2, refinement_iters=4,
                    mode="fixed")
    f = np.asarray(dis_flow_padded(jnp.asarray(flat1), jnp.asarray(flat2), cfg))
    assert np.isfinite(f).all()


def test_warp_formulations_bit_identical():
    """take4 / take2 / slice1 warp gathers fetch the same four corner
    taps (replicate padding reproduces the edge clamp), so outputs must
    be bit-identical — they exist purely as gather-shape A/B
    candidates."""
    import dis_tpu.ops.variational as vmod

    rng = np.random.default_rng(11)
    planes = jnp.asarray(rng.random((37, 53, 6)).astype(np.float32))
    flow = jnp.asarray((rng.random((37, 53, 2)).astype(np.float32) - 0.5) * 9)
    old = vmod._WARP
    try:
        outs = {}
        for mode in ("take4", "take2", "slice1"):
            vmod._WARP = mode
            out, inb = vmod._warp_bilinear(planes, flow)
            outs[mode] = np.asarray(out)
        np.testing.assert_array_equal(outs["take4"], outs["take2"])
        np.testing.assert_array_equal(outs["take4"], outs["slice1"])
    finally:
        vmod._WARP = old


def test_warp1_scheme_runs_and_improves_subpixel_epe():
    """The one-plane gradient-averaging linearization (OpenCV
    VariationalRefinement structure, refinement_scheme='warp1') is a
    valid refinement: improves sub-pixel EPE over no refinement.  It is
    an option, not the default."""
    i1, i2 = synthetic_pair(48, 64, shift=(1.5, 0.5), seed=23)
    gt = np.zeros((48, 64, 2), np.float32)
    gt[..., 0] = 1.5
    gt[..., 1] = 0.5
    base_cfg = DISConfig(iterations=20, coarsest_scale=2, patch_overlap=0.5,
                         mode="fixed", refinement_iters=0)
    ref_cfg = DISConfig(iterations=20, coarsest_scale=2, patch_overlap=0.5,
                        mode="fixed", refinement_iters=1,
                        refine_per_level=True, refinement_inner_sweeps=5,
                        refinement_sor_sweeps=5, refinement_omega=1.6,
                        refinement_scheme="warp1")
    # eager on purpose: jitting this warp1 refine-per-level program
    # late in the suite process reproducibly segfaulted the XLA CPU
    # compiler (2/2 full-suite runs at exactly this test; fine in a
    # fresh process) — keep the compile small until the upstream
    # compiler bug is gone.
    eager_flow = getattr(dis_flow_padded, "__wrapped__", dis_flow_padded)
    f0 = np.asarray(eager_flow(jnp.asarray(i1), jnp.asarray(i2), base_cfg))
    f1 = np.asarray(eager_flow(jnp.asarray(i1), jnp.asarray(i2), ref_cfg))
    e0 = epe(f0[8:-8, 8:-8], gt[8:-8, 8:-8])
    e1 = epe(f1[8:-8, 8:-8], gt[8:-8, 8:-8])
    assert np.isfinite(e1)
    assert e1 <= e0 + 0.02, (e0, e1)


def test_intensity_planes_improve_subpixel_epe():
    """refinement_planes='intensity' (the DIS paper's data term: the raw
    image resize chain, not the quirk-Q1 magnitude planes) runs and
    improves sub-pixel EPE over no refinement.  Measured on the synthetic
    families it is the better data term (natural_warp 0.0988 -> 0.0656 at
    384x512 DIS_MEDIUM; config.py::refinement_planes)."""
    i1, i2 = synthetic_pair(48, 64, shift=(1.5, 0.5), seed=29)
    gt = np.zeros((48, 64, 2), np.float32)
    gt[..., 0] = 1.5
    gt[..., 1] = 0.5
    base_cfg = DISConfig(iterations=20, coarsest_scale=2, patch_overlap=0.5,
                         mode="fixed", refinement_iters=0)
    ref_cfg = DISConfig(iterations=20, coarsest_scale=2, patch_overlap=0.5,
                        mode="fixed", refinement_iters=1,
                        refine_per_level=True, refinement_inner_sweeps=5,
                        refinement_sor_sweeps=5, refinement_omega=1.6,
                        refinement_planes="intensity")
    f0 = np.asarray(dis_flow_padded(jnp.asarray(i1), jnp.asarray(i2), base_cfg))
    f1 = np.asarray(dis_flow_padded(jnp.asarray(i1), jnp.asarray(i2), ref_cfg))
    e0 = epe(f0[8:-8, 8:-8], gt[8:-8, 8:-8])
    e1 = epe(f1[8:-8, 8:-8], gt[8:-8, 8:-8])
    assert np.isfinite(e1)
    assert e1 <= e0 + 0.02, (e0, e1)


def test_intensity_planes_differ_from_q1_planes():
    """The two data terms must actually read different planes (a wiring
    regression that silently fed Q1 planes to both would pass the
    improvement test above)."""
    i1, i2 = synthetic_pair(48, 64, shift=(1.5, 0.5), seed=29)
    kw = dict(iterations=20, coarsest_scale=2, patch_overlap=0.5,
              mode="fixed", refinement_iters=1, refine_per_level=True,
              refinement_inner_sweeps=5, refinement_sor_sweeps=5,
              refinement_omega=1.6)
    fq = np.asarray(dis_flow_padded(jnp.asarray(i1), jnp.asarray(i2),
                                    DISConfig(refinement_planes="q1", **kw)))
    fi = np.asarray(dis_flow_padded(jnp.asarray(i1), jnp.asarray(i2),
                                    DISConfig(refinement_planes="intensity",
                                              **kw)))
    assert not np.array_equal(fq, fi)


def test_intensity_planes_grid_tiled_matches_untiled():
    """Grid-tiled execution with the intensity data term stays bitwise
    equal to the untiled pipeline (the engines share refine_level and
    build_refinement_planes, so the refinement program is identical)."""
    from dis_tpu.parallel.tiles import grid_tiled_flow

    i1, i2 = synthetic_pair(48, 64, shift=(1.5, 0.5), seed=31)
    cfg = DISConfig(iterations=12, coarsest_scale=2, patch_overlap=0.5,
                    mode="fixed", refinement_iters=1, refine_per_level=True,
                    refinement_inner_sweeps=3, refinement_sor_sweeps=2,
                    refinement_omega=1.6, refinement_planes="intensity")
    from dis_tpu.ops.image import pad_divisible
    p1, _ = pad_divisible(jnp.asarray(i1), cfg.coarsest_scale)
    p2, _ = pad_divisible(jnp.asarray(i2), cfg.coarsest_scale)
    # bitwise engine-vs-untiled gate: use the EAGER reference (the
    # calibration baseline; see the note in test_stripe_exact.py)
    eager_flow = getattr(dis_flow_padded, "__wrapped__", dis_flow_padded)
    want = np.asarray(eager_flow(p1, p2, cfg))
    got = np.asarray(grid_tiled_flow(p1, p2, cfg, 3))
    np.testing.assert_array_equal(want, got)


def test_intensity_pyramid_matches_opencv_resize_chain():
    """intensity_pyramid is the same INTER_LINEAR x0.5 chain OpenCV's
    pyramid uses (main.cpp:29), applied to the RAW image."""
    cv2 = pytest.importorskip("cv2")
    from dis_tpu.ops.pyramid import intensity_pyramid

    rng_ = np.random.default_rng(7)
    img = rng_.random((40, 56)).astype(np.float32) * 255.0
    planes = intensity_pyramid(jnp.asarray(img), 2)
    ref = img
    np.testing.assert_allclose(np.asarray(planes[0]), ref, rtol=0, atol=0)
    for s in (1, 2):
        ref = cv2.resize(ref, (ref.shape[1] // 2, ref.shape[0] // 2),
                         interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(np.asarray(planes[s]), ref,
                                   rtol=0, atol=2e-4)
