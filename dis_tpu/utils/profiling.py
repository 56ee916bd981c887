"""Tracing / profiling hooks.

The reference's only observability is ``cout`` progress lines
(main.cpp:110,205; optical_flow.cpp:69).  Here: named-scope trace
annotations per phase (already emitted inside the pipeline via
``jax.named_scope``: pyramid / scale_N / variational_refinement),
an xprof-compatible trace context, and a lightweight phase timer for
JSON-lines run logs.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (viewable in XProf/TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Wall-clock phase timing with JSON-lines output.

    Note: under async dispatch the device work attributed to a phase
    completes when its outputs are blocked on; time phases around
    ``jax.block_until_ready`` for honest numbers.
    """

    def __init__(self, log_path: Optional[str] = None):
        self.log_path = log_path
        self.records: list = []

    @contextlib.contextmanager
    def phase(self, name: str, **meta) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            rec = {"phase": name, "seconds": dt, **meta}
            self.records.append(rec)
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["phase"]] = out.get(r["phase"], 0.0) + r["seconds"]
        return out
