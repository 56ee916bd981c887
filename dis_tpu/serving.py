"""AOT compilation and serialized-executable export (the serving path).

The reference's only deployment story is re-running its CLI binary per
sequence (``/root/reference/src/main.cpp:102-209``): every launch pays
process startup, and a JAX port would additionally pay trace+compile
before the first frame.  This module gives the build a production
serving path:

- :func:`aot_compile` — ahead-of-time compile a fixed-shape flow
  executable once (``jax.jit(...).lower(...).compile()``); callers get a
  :class:`CompiledFlow` that never retraces and exposes the compiler's
  own FLOP/memory cost analysis.
- :func:`export_flow` / :func:`save_exported` / :func:`load_exported` —
  export the lowered computation with ``jax.export`` (StableHLO) and
  serialize it, so a serving process can load and run it with **no
  Python tracing at all**, or a fleet can ship one artifact to many
  identical workers.  An artifact
  targets the platform it was exported on and lowers the same search
  that :func:`aot_compile` runs there: a GPU export embeds the
  Pallas-Triton search kernel, a CPU export is pure XLA.

Shapes are static by design — XLA serving wants one program per shape
bucket.  Arbitrary input
sizes are handled by the divisibility pad/crop inside
:func:`~dis_tpu.models.dis.dis_flow`, so one bucket serves every frame
of a fixed-resolution stream.

CLI: ``python -m dis_tpu.serving export --size 436x1024 --out dis.jaxexp``
then ``python -m dis_tpu.serving run dis.jaxexp`` (smoke-executes the
artifact on synthetic frames and prints timing).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .config import DISConfig, PRESETS
from .models.dis import dis_flow


def _flow_fn(cfg: DISConfig, batch: Optional[int]):
    """Single-pair [H,W] or batched [B,H,W] flow function (full C13
    post-processing — upsample + crop — so output is input-resolution)."""
    if batch is None:
        return lambda a, b: dis_flow(a, b, cfg)
    return jax.vmap(lambda a, b: dis_flow(a, b, cfg))


def _arg_structs(height: int, width: int, batch: Optional[int]):
    shape = (height, width) if batch is None else (batch, height, width)
    s = jax.ShapeDtypeStruct(shape, jnp.float32)
    return s, s


@dataclasses.dataclass
class CompiledFlow:
    """A fixed-shape, ahead-of-time-compiled flow executable.

    Calling it never retraces or recompiles; inputs must match
    ``(height, width)`` (plus the leading ``batch`` dim if set).
    """

    compiled: jax.stages.Compiled
    height: int
    width: int
    batch: Optional[int]
    cfg: DISConfig

    def __call__(self, img1, img2) -> jax.Array:
        a = jnp.asarray(img1, jnp.float32)
        b = jnp.asarray(img2, jnp.float32)
        want = ((self.height, self.width) if self.batch is None
                else (self.batch, self.height, self.width))
        if a.shape != want or b.shape != want:
            raise ValueError(
                f"compiled for {want}, got {a.shape} / {b.shape}; "
                f"aot_compile a new bucket for other shapes")
        return self.compiled(a, b)

    def cost_analysis(self) -> dict:
        """Compiler-reported cost analysis (flops, bytes accessed)."""
        c = self.compiled.cost_analysis()
        return c[0] if isinstance(c, (list, tuple)) else (c or {})

    def memory_analysis(self):
        """Compiler-reported memory analysis (may be None on CPU)."""
        return self.compiled.memory_analysis()


def aot_compile(cfg: DISConfig, height: int, width: int,
                batch: Optional[int] = None) -> CompiledFlow:
    """Ahead-of-time compile the flow pipeline for one shape bucket.

    Pays the trace+compile cost now (once), not on the first served
    request.  ``batch=None`` compiles the single-pair [H,W] program;
    ``batch=B`` the vmapped [B,H,W] program (the search kernel folds the
    batch into its launch grid via its ``custom_vmap`` rule).
    """
    fn = jax.jit(_flow_fn(cfg, batch))
    lowered = fn.lower(*_arg_structs(height, width, batch))
    return CompiledFlow(lowered.compile(), height, width, batch, cfg)


# The Pallas-Triton search kernel lowers to this custom call; jax.export
# does not list it as stable because Triton IR carries no compatibility
# guarantee across versions.
_TRITON_CALL = "__gpu$xla.gpu.triton"


def export_flow(cfg: DISConfig, height: int, width: int,
                batch: Optional[int] = None) -> jax.export.Exported:
    """Export the flow program with ``jax.export`` (in memory).

    The artifact targets the platform this process runs on and lowers
    the same search :func:`aot_compile` runs there.  On the GPU it embeds
    the Triton search kernel, whose custom call jax.export does not
    guarantee stable: the one check that refuses it is disabled here, so
    a GPU artifact is tied to the JAX version that exported it (load it
    with the same version).  A CPU artifact carries only StableHLO and
    replays under jax.export's compatibility guarantees.
    ``Exported.serialize()`` (used by :func:`save_exported`) needs JAX's
    optional ``flatbuffers`` dependency; running an in-memory artifact
    does not.
    """
    from .backend import platform

    fn = jax.jit(_flow_fn(cfg, batch))
    checks = ([jax.export.DisabledSafetyCheck.custom_call(_TRITON_CALL)]
              if platform() == "gpu" else [])
    return jax.export.export(fn, disabled_checks=checks)(
        *_arg_structs(height, width, batch))


def save_exported(path: str, cfg: DISConfig, height: int, width: int,
                  batch: Optional[int] = None) -> None:
    """Serialize :func:`export_flow`'s artifact to ``path``."""
    data = export_flow(cfg, height, width, batch).serialize()
    with open(path, "wb") as f:
        f.write(data)


def load_exported(artifact):
    """Load an artifact — an in-memory ``jax.export.Exported``, its
    serialized bytes, or a file path; returns ``(fn, exported)`` with
    ``fn(img1, img2) -> flow``.

    The returned callable runs the embedded StableHLO via
    ``jax.export``'s calling convention (jittable, no Python tracing of
    the pipeline itself).  Must be loaded on a platform the artifact
    was lowered for.
    """
    if isinstance(artifact, jax.export.Exported):
        exp = artifact
    else:
        if isinstance(artifact, (bytes, bytearray)):
            data = bytes(artifact)
        else:
            with open(artifact, "rb") as f:
                data = f.read()
        exp = jax.export.deserialize(bytearray(data))

    def run(img1, img2):
        return exp.call(jnp.asarray(img1, jnp.float32),
                        jnp.asarray(img2, jnp.float32))

    return run, exp


def _parse_size(s: str) -> Tuple[int, int]:
    h, w = s.lower().split("x")
    return int(h), int(w)


def main(argv=None) -> int:
    import argparse
    import time

    ap = argparse.ArgumentParser(prog="dis_tpu.serving", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="serialize a flow program")
    ex.add_argument("--size", required=True, metavar="HxW")
    ex.add_argument("--batch", type=int, default=None)
    ex.add_argument("--preset", default="fast", choices=sorted(PRESETS))
    ex.add_argument("--mode", default="compat", choices=("compat", "fixed"))
    ex.add_argument("--out", required=True)
    rn = sub.add_parser("run", help="smoke-run an exported artifact")
    rn.add_argument("artifact")
    rn.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    from .backend import setup_compile_cache

    setup_compile_cache()
    if args.cmd == "export":
        h, w = _parse_size(args.size)
        cfg = dataclasses.replace(PRESETS[args.preset], mode=args.mode)
        save_exported(args.out, cfg, h, w, args.batch)
        print(f"exported {args.size} batch={args.batch} preset={args.preset} "
              f"-> {args.out}")
        return 0

    run, exp = load_exported(args.artifact)
    shape = exp.in_avals[0].shape
    r = np.random.default_rng(0)
    a = r.random(shape, dtype=np.float32) * 255
    b = r.random(shape, dtype=np.float32) * 255
    flow = np.asarray(run(a, b))  # compile+execute
    t0 = time.perf_counter()
    for _ in range(args.reps):
        flow = np.asarray(run(a, b))
    dt = (time.perf_counter() - t0) / args.reps
    print(f"in {shape} -> flow {flow.shape}; {dt * 1e3:.2f} ms/call "
          f"(|u| mean {np.abs(flow).mean():.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
