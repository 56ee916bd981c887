"""Serving path: AOT compilation and jax.export round trips.

The reference has no serving story (its deployment is re-running the
CLI binary, main.cpp:102-209); these tests pin the build's
production path: fixed-shape AOT executables and serialized artifacts
must reproduce the traced pipeline bit-for-bit.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import synthetic_pair

from dis_tpu.config import DISConfig
from dis_tpu.models.dis import dis_flow
from dis_tpu import serving

CFG = DISConfig(iterations=8, patch_size=8, coarsest_scale=2,
                finest_scale=0, patch_overlap=0.3, mode="compat",
                early_exit=False)


def _jit_flow(a, b):
    """The jitted pipeline is the equality reference: AOT/exported
    programs run the same XLA executable, so they must match bitwise
    (eager mode differs by fusion-order fp fuzz ~5e-6)."""
    return np.asarray(jax.jit(lambda x, y: dis_flow(x, y, CFG))(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))


def test_aot_compile_matches_traced():
    i1, i2 = synthetic_pair(44, 60)
    want = _jit_flow(i1, i2)
    cf = serving.aot_compile(CFG, 44, 60)
    got = np.asarray(cf(i1, i2))
    np.testing.assert_array_equal(got, want)
    # Cost analysis is the compiler's own; just require it to exist and
    # report nonzero work for a real pipeline.
    cost = cf.cost_analysis()
    assert cost.get("flops", 0) > 0


def test_aot_shape_guard():
    cf = serving.aot_compile(CFG, 44, 60)
    i1, i2 = synthetic_pair(48, 64)
    with pytest.raises(ValueError, match="compiled for"):
        cf(i1, i2)


def test_aot_batched_matches_singles():
    pairs = [synthetic_pair(40, 56, seed=s) for s in (0, 1, 2)]
    i1 = np.stack([p[0] for p in pairs])
    i2 = np.stack([p[1] for p in pairs])
    cf = serving.aot_compile(CFG, 40, 56, batch=3)
    got = np.asarray(cf(i1, i2))
    for k, (a, b) in enumerate(pairs):
        # vmap-of-pipeline vs single-pair program: same math, possibly
        # different fusion order on CPU — allow tiny fp fuzz.
        np.testing.assert_allclose(got[k], _jit_flow(a, b), atol=1e-4)


def test_export_roundtrip(tmp_path):
    i1, i2 = synthetic_pair(44, 60)
    want = _jit_flow(i1, i2)
    path = str(tmp_path / "flow.jaxexp")
    serving.save_exported(path, CFG, 44, 60)
    assert os.path.getsize(path) > 0
    run, exp = serving.load_exported(path)
    assert exp.in_avals[0].shape == (44, 60)
    got = np.asarray(run(i1, i2))
    np.testing.assert_array_equal(got, want)


def test_export_in_memory_and_bytes():
    """export_flow returns the in-memory artifact; load_exported runs it
    as is or from its serialized bytes, with the traced pipeline's flow."""
    i1, i2 = synthetic_pair(44, 60)
    want = _jit_flow(i1, i2)
    exp = serving.export_flow(CFG, 44, 60)
    for art in (exp, exp.serialize()):
        run, _ = serving.load_exported(art)
        np.testing.assert_array_equal(np.asarray(run(i1, i2)), want)


def test_serving_cli_export_and_run(tmp_path, capsys):
    path = str(tmp_path / "a.jaxexp")
    assert serving.main(["export", "--size", "40x48", "--preset",
                         "ultrafast", "--mode", "compat",
                         "--out", path]) == 0
    assert serving.main(["run", path, "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert "flow (40, 48, 2)" in out
