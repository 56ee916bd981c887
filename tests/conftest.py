"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``); per the standard JAX
pattern, sharding/halo-exchange tests run against
``--xla_force_host_platform_device_count=8``.  Must be set before JAX
initializes.  On the card, ``python chip_smoke.py`` is the check.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# The entry points under test point JAX's persistent compile cache at
# <checkout>/.jax_cache (dis_tpu.backend.setup_compile_cache); tests
# compile fresh and leave no cache behind.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Auto-jit the pipeline entry points for the whole test session (round-5
# fast-loop fix): many tests call dis_flow / dis_flow_padded /
# variational_refinement EAGERLY at top level, and on CPU the op-by-op
# dispatch of the full pipeline is ~6x slower than one jitted program
# (the padding-roundtrip test alone billed 187s; jitted it is ~17s).
# The wrapper jits ONLY non-traced (top-level) calls: when any argument
# is a tracer — i.e. the symbol is being called from inside another
# jitted program, like the tiled engines calling refine_level /
# variational_refinement through the module global — the ORIGINAL
# function runs inline, so inner-program fusion (and therefore every
# bitwise tiled==untiled gate) is untouched.  For the top-level calls,
# jit == eager was verified bitwise for dis_flow_padded on the gate
# configs, and the suite's golden/oracle comparisons re-check it every
# run.
import functools as _functools  # noqa: E402

import dis_tpu.models.dis as _dis_mod  # noqa: E402
import dis_tpu.ops.variational as _var_mod  # noqa: E402


def _jit_toplevel(fn, static):
    jitted = jax.jit(fn, static_argnames=static)

    @_functools.wraps(fn)
    def wrapper(*args, **kw):
        import jax.core

        leaves = jax.tree_util.tree_leaves((args, kw))
        if any(isinstance(a, jax.core.Tracer) for a in leaves):
            return fn(*args, **kw)
        return jitted(*args, **kw)

    return wrapper


_dis_mod.dis_flow_padded = _jit_toplevel(
    _dis_mod.dis_flow_padded, ("cfg", "return_debug"))
_dis_mod.dis_flow = _jit_toplevel(_dis_mod.dis_flow, ("cfg",))
_var_mod.variational_refinement = _jit_toplevel(
    _var_mod.variational_refinement, ("cfg", "pad"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def synthetic_pair(h, w, shift=(2.0, 1.0), seed=0):
    """A smooth random image and a translated copy: ground truth flow is
    ``shift`` everywhere (away from borders)."""
    r = np.random.default_rng(seed)
    big = r.random((h + 64, w + 64)).astype(np.float32) * 255.0
    # Smooth so that gradients are informative at patch scale.
    k = np.ones((7, 7), np.float32) / 49.0
    from scipy.signal import convolve2d

    big = convolve2d(big, k, mode="same", boundary="symm").astype(np.float32)
    big = convolve2d(big, k, mode="same", boundary="symm").astype(np.float32)
    dx, dy = shift
    i1 = big[32 : 32 + h, 32 : 32 + w]
    # I2(x) = I1(x - shift) -> the flow from I1 to I2 is +shift everywhere.
    if float(dx).is_integer() and float(dy).is_integer():
        i2 = big[32 - int(dy) : 32 - int(dy) + h, 32 - int(dx) : 32 - int(dx) + w]
    else:
        from scipy.ndimage import shift as ndshift

        i2 = ndshift(big, (dy, dx), order=3, mode="nearest")[32 : 32 + h, 32 : 32 + w]
    return np.ascontiguousarray(i1), np.ascontiguousarray(i2.astype(np.float32))


@pytest.fixture
def small_pair():
    return synthetic_pair(48, 64, shift=(2.0, 1.0))
