"""Multi-host initialization and the scaling-efficiency harness.

``init_multi_host`` wraps ``jax.distributed.initialize`` for pod-slice
runs (coordinator + process index from env or args).  On a single host
it is a no-op, so the same entry point serves 1-chip, 1-host and
N-host launches (BASELINE.json config #5).

``scaling_report`` measures batched-flow throughput at increasing
device counts on the current platform and reports efficiency relative
to one device — the harness the multi-host benchmark runs per slice.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np


def init_multi_host(coordinator: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed when running on multiple hosts.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID);
    no-ops when none are present (single host).
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if coordinator and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )


def shard_frame_range(start: int, end: int, num_hosts: int,
                      host_id: int) -> tuple:
    """Contiguous split of the pair indices [start, end) across hosts.

    Pair i uses frames (i, i+1); a host's shard is self-contained
    because frame files are read from shared storage (the one-frame
    neighbor halo is a file read, not a device transfer).  Remainder
    pairs go to the leading hosts.
    """
    if not (0 <= host_id < num_hosts):
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    total = max(0, end - start)
    base = total // num_hosts
    rem = total % num_hosts
    lo = start + host_id * base + min(host_id, rem)
    hi = lo + base + (1 if host_id < rem else 0)
    return lo, hi


def run_sequence_shard(folder: str, start: int, end: int, cfg,
                       ckpt_root: str, host_id: Optional[int] = None,
                       num_hosts: Optional[int] = None, **kwargs) -> dict:
    """One host's share of a sequence run, checkpointed per shard.

    Wires together the multi-host pieces (SURVEY §5 elastic recovery):
    ``init_multi_host`` (env-driven, no-op on one host), the contiguous
    frame-range shard for this host, and a per-shard resumable
    checkpoint directory — so a killed worker relaunches with the same
    command line and continues where it stopped
    (tests/test_multihost.py runs the deliberate-kill scenario).
    """
    from ..runner import run_sequence

    init_multi_host()
    if num_hosts is None:
        num_hosts = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if host_id is None:
        host_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    lo, hi = shard_frame_range(start, end, num_hosts, host_id)
    summary = run_sequence(
        folder, lo, hi, cfg,
        ckpt_dir=os.path.join(ckpt_root, f"host_{host_id:03d}"),
        **kwargs)
    summary.update(host_id=host_id, num_hosts=num_hosts,
                   shard=(lo, hi))
    return summary


def measure_throughput(cfg, h: int, w: int, n_devices: int,
                       reps: int = 3) -> float:
    """Pairs/sec for a batch of n_devices pairs sharded over n_devices."""
    import jax
    import jax.numpy as jnp

    from ..config import DISConfig
    from .batch import batched_flow_fn
    from .mesh import make_mesh

    devs = jax.devices()[:n_devices]
    mesh = make_mesh((n_devices, 1), devices=devs)
    fn = batched_flow_fn(cfg, mesh)
    r = np.random.default_rng(0)
    a = jnp.asarray(r.random((n_devices, h, w)).astype(np.float32))
    b = jnp.asarray(r.random((n_devices, h, w)).astype(np.float32))

    out = fn(a, b)
    float(np.asarray(out).ravel()[0])  # warm + sync
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(a, b)
    float(np.asarray(out).ravel()[0])
    dt = (time.perf_counter() - t0) / reps
    return n_devices / dt


def scaling_report(cfg=None, h: int = 128, w: int = 160,
                   device_counts: Optional[List[int]] = None) -> dict:
    """Throughput + parallel efficiency across device counts."""
    import jax

    from ..config import DISConfig

    cfg = cfg or DISConfig(iterations=8, coarsest_scale=2,
                           patch_overlap=0.5, mode="fixed",
                           early_exit=False)
    n = jax.device_count()
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n]
    rows = []
    base = None
    for c in device_counts:
        tp = measure_throughput(cfg, h, w, c)
        if base is None:
            base = tp
        rows.append({
            "devices": c,
            "pairs_per_sec": round(tp, 3),
            "efficiency": round(tp / (base * c), 4),
        })
    from ..backend import platform

    return {"platform": platform(), "rows": rows}
