#!/usr/bin/env python
"""Capture and reduce a device-time budget for dis_tpu frames on the GPU.

A ``jax.profiler`` trace is the per-op ground truth: stage
micro-benchmarks mis-attribute costs (closure-captured operands
constant-fold, and an isolated win that unfuses the XLA graph can be an
end-to-end loss).  The reducer reads the trace's device plane
(``/device:GPU:N`` processes) and reports, per frame:

- device busy ms (union of kernel intervals) and the idle share of the
  window from the first to the last kernel;
- kernel ms per pipeline layer, from the ``jax.named_scope`` names the
  pipeline gives its stages (pyramid, scale_N, refine_sN, ...): each
  kernel's HLO instruction carries its scope in ``op_name`` metadata,
  read from the compiled module saved beside the trace (``hlo.txt``);
  the search kernel's launches are named ``iclk_search``;
- the top kernels by time.

Usage:
    python tools/trace_budget.py                       # 1080p compat
    python tools/trace_budget.py --config sintel_fast --kernel xla
    python tools/trace_budget.py --trace DIR           # reduce only
Prints one JSON summary line last; fails without a GPU when capturing.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import gzip
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> (padded HxW, config factory)
CONFIGS = {
    "compat1080": ((1088, 1920), lambda: _cfg("compat")),
    "sintel_fast": ((440, 1024), lambda: _cfg("fast")),
    "sintel_medium": ((440, 1024), lambda: _cfg("medium")),
    "fast4k": ((2176, 3840), lambda: _cfg("fast")),
}

_LAYER = re.compile(r"(pyramid|variational_refinement|refine_s\d+|"
                    r"stripe_scale_\d+|scale_\d+)")


def _cfg(name):
    from dis_tpu.config import DIS_FAST, DIS_MEDIUM, DISConfig

    if name == "compat":   # bench.py's configuration
        return DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                         finest_scale=0, patch_overlap=0.3, mode="compat",
                         early_exit=False)
    return {"fast": DIS_FAST, "medium": DIS_MEDIUM}[name]


def capture(trace_dir: str, config: str, frames: int = 3, batch: int = 1,
            kernel: str = "auto", sampler: str = "region") -> None:
    import jax
    import jax.numpy as jnp

    from dis_tpu.models.dis import dis_flow_padded
    from dis_tpu.utils import synth

    (h, w), make = CONFIGS[config]
    cfg = dataclasses.replace(make(), kernel=kernel, sampler=sampler)
    pairs = [synth.translation(h, w, seed=s)[:2] for s in range(batch)]
    i1 = jnp.asarray(pairs[0][0] if batch == 1
                     else [p[0] for p in pairs])
    i2 = jnp.asarray(pairs[0][1] if batch == 1
                     else [p[1] for p in pairs])
    flow = lambda a, b: dis_flow_padded(a, b, cfg)
    fn = jax.jit(flow if batch == 1 else jax.vmap(flow)).lower(
        i1, i2).compile()
    jax.block_until_ready(fn(i1, i2))  # warm outside the trace
    with jax.profiler.trace(trace_dir):
        for _ in range(frames):
            jax.block_until_ready(fn(i1, i2))
    with open(os.path.join(trace_dir, "hlo.txt"), "w") as f:
        f.write(fn.as_text())


def _scopes(trace_dir: str) -> dict:
    """Kernel name -> pipeline layer, from the compiled module's
    ``op_name`` metadata (kernel names are HLO names with '.' -> '_')."""
    path = os.path.join(trace_dir, "hlo.txt")
    if not os.path.exists(path):
        return {}
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r'\s*(?:ROOT )?%?([\w.\-]+) = .*op_name="([^"]*)',
                         line)
            if m:
                layers = _LAYER.findall(m.group(2))
                if layers:   # the innermost scope: refine_s0 in scale_0
                    out[m.group(1).replace(".", "_")] = layers[-1]
    return out


def _union_ms(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def summarize(trace_dir: str, frames: int, top: int = 15) -> dict:
    """Reduce the newest trace under ``trace_dir`` to per-frame numbers."""
    paths = glob.glob(os.path.join(trace_dir,
                                   "plugins/profile/*/*.trace.json.gz"))
    if not paths:
        raise SystemExit(f"no trace under {trace_dir}")
    with gzip.open(sorted(paths)[-1]) as fh:
        tr = json.load(fh)
    meta = [e for e in tr["traceEvents"] if e.get("ph") == "M"]
    procs = {e["pid"]: e["args"].get("name", "") for e in meta
             if e.get("name") == "process_name"}
    threads = {(e["pid"], e["tid"]): e["args"].get("name", "") for e in meta
               if e.get("name") == "thread_name"}
    dev_pids = {p for p, n in procs.items() if "/device:GPU" in n}
    if not dev_pids:
        raise SystemExit(f"no GPU device plane in the trace: {procs}")
    # Kernel events live on the device's stream lines; derived lines
    # (XLA Ops / Modules) duplicate them and are not summed.
    ev = [e for e in tr["traceEvents"]
          if e.get("ph") == "X" and e.get("pid") in dev_pids
          and "stream" in threads.get((e["pid"], e.get("tid")), "").lower()]
    if not ev:
        raise SystemExit("no kernel events on the device streams: "
                         f"{sorted(set(threads.values()))}")
    lines = collections.Counter(
        threads.get((e["pid"], e.get("tid")), "") for e in ev)
    scopes = _scopes(trace_dir)
    per_op = collections.Counter()
    per_layer = collections.Counter()
    for e in ev:
        ms = e.get("dur", 0) / 1e3
        per_op[e["name"]] += ms
        if e["name"].startswith("iclk_search"):
            layer = "iclk_search"
        else:
            layer = scopes.get(e["name"], "other")
        per_layer[layer] += ms
    t0 = min(e["ts"] for e in ev)
    t1 = max(e["ts"] + e.get("dur", 0) for e in ev)
    busy = _union_ms((e["ts"], e["ts"] + e.get("dur", 0)) for e in ev)
    window = (t1 - t0) / 1e3
    out = {
        "frames": frames,
        "kernel_ms_per_frame": sum(per_op.values()) / frames,
        "busy_ms_per_frame": busy / frames,
        "window_ms_per_frame": window / frames,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "layers_ms_per_frame": {k: v / frames
                                for k, v in per_layer.most_common()},
        "top_ops_ms_per_frame": {k[:80]: v / frames
                                 for k, v in per_op.most_common(top)},
        "stream_lines": dict(lines),
    }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="existing trace dir (skip capture)")
    ap.add_argument("--out", default=os.path.join(ROOT, ".trace"),
                    help="trace directory to write")
    ap.add_argument("--config", default="compat1080", choices=CONFIGS)
    ap.add_argument("--kernel", default="auto",
                    choices=("auto", "pallas", "xla"))
    ap.add_argument("--sampler", default="region",
                    choices=("region", "global"),
                    help="XLA search sampler (kernel=xla)")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1,
                    help="trace the vmapped batched pipeline")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    d = args.trace
    if d is None:
        sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
        from timing import card, require_gpu

        from dis_tpu.backend import setup_compile_cache

        require_gpu()
        setup_compile_cache()
        print(card())
        d = args.out
        capture(d, args.config, args.frames, args.batch, args.kernel,
                args.sampler)
    s = summarize(d, args.frames * args.batch, args.top)
    s.update(config=args.config, kernel=args.kernel, sampler=args.sampler,
             batch=args.batch)
    print(json.dumps(s))


if __name__ == "__main__":
    main()
