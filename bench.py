#!/usr/bin/env python
"""Benchmark: frames/sec on one card at the 1080p DIS-fast preset.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/sec/card", "vs_baseline": N}
and the card's name and power limit on stderr.  Fails without a GPU.

- "value": steady-state single-card throughput of the JAX pipeline
  on a 1920x1080 pair with the DIS-fast parameter set (iterations=16,
  patch 8, stride 5, scales 3..0), compat semantics.
- "vs_baseline": ratio vs the single-threaded C++ baseline
  (tools/cpp_baseline — our own implementation of the same compat
  semantics, equivalent work per frame; the reference repo publishes no
  numbers and is Windows-only, see BASELINE.md).

Both sides run identical parameters and identical inputs.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOOL_DIR = os.path.join(ROOT, "tools", "cpp_baseline")
BIN = os.path.join(TOOL_DIR, "dis_baseline")

W, H = 1920, 1080
ITERS, PS, COARSEST, FINEST, OVERLAP, NORM = 16, 8, 3, 0, 0.3, 1
BASELINE_CACHE = os.path.join(ROOT, ".bench_baseline.json")


def synth_pair():
    from scipy.signal import convolve2d

    r = np.random.default_rng(42)
    big = (r.random((H + 16, W + 16)) * 255).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0
    big = convolve2d(big, k, mode="same", boundary="symm").astype(np.float32)
    i1 = big[8:8 + H, 8:8 + W]
    i2 = big[6:6 + H, 5:5 + W]  # ~(3, 2) px shift
    return np.ascontiguousarray(i1), np.ascontiguousarray(i2)


def baseline_fps(i1, i2):
    """Single-thread C++ fps; cached across runs (it is slow but stable)."""
    if os.path.exists(BASELINE_CACHE):
        try:
            with open(BASELINE_CACHE) as f:
                d = json.load(f)
            if d.get("config") == [W, H, ITERS, PS, COARSEST, FINEST, OVERLAP]:
                return d["fps"]
        except Exception:
            pass
    if not os.path.exists(BIN):
        subprocess.run(["make", "-C", TOOL_DIR], check=True,
                       capture_output=True)
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        p1 = os.path.join(td, "a.f32")
        p2 = os.path.join(td, "b.f32")
        i1.astype("<f4").tofile(p1)
        i2.astype("<f4").tofile(p2)
        out = subprocess.run(
            [BIN, str(W), str(H), str(ITERS), str(PS), str(COARSEST),
             str(FINEST), str(OVERLAP), str(NORM), "1", p1, p2],
            capture_output=True, text=True, check=True, timeout=3600)
    fps = json.loads(out.stdout.strip().splitlines()[-1])["fps"]
    with open(BASELINE_CACHE, "w") as f:
        json.dump({"config": [W, H, ITERS, PS, COARSEST, FINEST, OVERLAP],
                   "fps": fps}, f)
    return fps


def gpu_fps(i1, i2):
    """Steady-state frames/sec on the card (benchmarks/timing.py)."""
    import jax
    import jax.numpy as jnp

    from dis_tpu.config import DISConfig
    from dis_tpu.models.dis import dis_flow_padded
    from timing import time_call

    cfg = DISConfig(iterations=ITERS, patch_size=PS, coarsest_scale=COARSEST,
                    finest_scale=FINEST, patch_overlap=OVERLAP,
                    patch_normalization=bool(NORM), mode="compat",
                    early_exit=False)
    fn = jax.jit(lambda a, b: dis_flow_padded(a, b, cfg))
    t = time_call(fn, jnp.asarray(i1), jnp.asarray(i2), reps=20)
    return 1.0 / t["median_s"], t


def main():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from timing import CPP_LEDGER_FPS, card, require_gpu

    from dis_tpu.backend import setup_compile_cache

    devs = require_gpu()
    setup_compile_cache()
    print(card(), file=sys.stderr)
    i1, i2 = synth_pair()
    ours, t = gpu_fps(i1, i2)
    base_local = baseline_fps(i1, i2)
    # vs_baseline is pinned to benchmarks/timing.py::CPP_LEDGER_FPS; the
    # machine-local cached measurement is reported alongside.
    print(json.dumps({
        "metric": "frames/sec/card @1080p DIS-fast (compat semantics)",
        "value": round(ours, 4),
        "unit": "frames/sec/card",
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "compile_s": round(t["compile_s"], 3),
        "reps": t["reps"],
        "vs_baseline": round(ours / CPP_LEDGER_FPS, 4),
        "baseline_fps_pinned_ledger": CPP_LEDGER_FPS,
        "baseline_fps_local_cache": round(base_local, 4),
        "vs_local_cache": round(ours / base_local, 4),
    }))


if __name__ == "__main__":
    main()
