"""ONE timing methodology for every benchmark artifact.

``time_call`` times ``fn(*args)`` with the host clock around work that
ends in ``jax.block_until_ready``: the first call compiles and is
reported as set-up, the rest are the steady-state samples (median and
90th percentile over a stated count).  ``require_gpu`` makes a
measurement fail rather than fall back to the CPU, and ``card`` reads
the card's name and power limit, which belong beside every number.

C++ baseline denominator convention: the PINNED denominator for every
``vs_baseline`` field is the ledger's 1.45 fps — the HIGHEST C++
reading ever recorded for tools/cpp_baseline on this workload, i.e. the
most conservative speedup claim.  Artifacts also report the
machine-local cached measurement, labeled as such.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np

# Pinned vs_baseline denominator: see module docstring.
CPP_LEDGER_FPS = 1.45


def time_call(fn, *args, reps: int = 10) -> dict:
    """Compile seconds, then ``reps`` steady-state seconds per call."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return {"compile_s": compile_s,
            "median_s": float(np.median(samples)),
            "p90_s": float(np.percentile(samples, 90)),
            "reps": reps}


def parse_card(line: str) -> dict:
    """Parse one ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` line, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    name, _, limit = line.strip().rpartition(",")
    if not name or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return {"name": name.strip(), "power_limit": limit.strip()}


def card() -> str:
    """The first card's ``name, power.limit`` line from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    line = out.stdout.strip().splitlines()[0]
    parse_card(line)
    return line


def require_gpu():
    """The JAX devices, or RuntimeError when the first is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devs[0].platform!r}; this measurement "
            f"runs only on the card")
    return devs
