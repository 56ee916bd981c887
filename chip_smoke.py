#!/usr/bin/env python
"""Smoke check of dis_tpu on an NVIDIA GPU, through the user entry points.

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --four-cards  # a four-card host: the multi-card
                                       # engines against one card, only

Phases (one card):
  1. device  — the first JAX device is a GPU; the card's name and power
     limit (nvidia-smi) and the compile-cache directory.
  2. kernels — the Pallas-Triton IC-LK search against the XLA search on
     the same templates and init (1080p, finest and coarsest scale,
     compat and fixed); the other operations (pyramid, templates,
     densify, one refinement level) on the card against the same code
     on the host CPU, in this process.
  3. end to end — ``dis_flow`` at 1080p DIS-fast compat, Sintel
     436x1024 with DIS_FAST and DIS_MEDIUM, and 4K (2176x3840) DIS-fast,
     each against the CPU run of the same code on the same synthetic
     pair; compile seconds, ms/frame and the compiler's memory analysis;
     no f32 matrix product or convolution below HIGHEST precision.
  4. serving and host paths — ``serving.aot_compile`` answers requests,
     ``export_flow``/``load_exported`` gives the same flow (in memory,
     and serialized where JAX's optional flatbuffers is installed),
     ``runner.run_sequence`` and ``cli.main`` write .flo files that read
     back, with no imaging library loaded.
  5. batched — ``jax.vmap`` over two pairs equals serial runs bitwise.

Any failed check raises: the script then exits nonzero and prints no
result line.  The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Gates (phase 2 and 3); the reasons are in the comparison helpers.
SEARCH_U_TOL = 1e-3        # px, final u of patches that froze alike
SEARCH_FLIP_MAX = 0.005    # share of patches whose freeze decision flips
OP_RTOL = 1e-5             # card vs host CPU, relative to max |reference|
EPE_TOL = 0.005            # px, |EPE(card) - EPE(cpu)| to the known shift
DIFF_PX = 0.01             # px, a pixel "differs" above this
DIFF_SHARE_MAX = 0.005     # share of pixels that may differ

# Frame sizes (H, W): the deployments the one-card phases run at.
FRAME_1080 = (1088, 1920)  # kernel phase: padded 1080p
SINTEL = (436, 1024)
E2E = [("1080p DIS-fast compat", "compat", (1080, 1920)),
       ("Sintel 436x1024 DIS_FAST", "fast", SINTEL),
       ("Sintel 436x1024 DIS_MEDIUM", "medium", SINTEL),
       ("4K 2176x3840 DIS_FAST", "fast", (2176, 3840))]
KITTI = (376, 1248)        # four-card batched engine (padded KITTI)
CLIP = (440, 1024)         # four-card sequence engine (padded Sintel)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name}: passed in {time.perf_counter() - t0:.1f} s")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|: a float32 error relative to the
    array's own scale (elementwise relative error is meaningless where
    the reference crosses zero)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        raise AssertionError("non-finite values")
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    return float(np.abs(got - want).max()) / scale if want.size else 0.0


def check_close(name: str, got, want, rtol: float = OP_RTOL) -> None:
    e = rel_err(got, want)
    log(f"  {name}: rel err {e:.3e} (limit {rtol:g})")
    if e > rtol:
        raise AssertionError(f"{name}: rel err {e:.3e} > {rtol:g}")


def search_agreement(u_a, conv_a, u_b, conv_b) -> dict:
    """Two IC-LK searches on the same inputs.  A discrete decision on a
    knife edge (a policing reset, or the iteration at which a fixed-mode
    patch converges) can flip when sums reduce in another order; such a
    patch ends with a different freeze flag or a final u more than
    SEARCH_U_TOL apart.  Returns the share of those flips and the
    largest |du| among the patches that did not flip."""
    u_a, u_b = np.asarray(u_a), np.asarray(u_b)
    du = np.abs(u_a - u_b).max(axis=1)
    flip = (np.asarray(conv_a) != np.asarray(conv_b)) | (du > SEARCH_U_TOL)
    rest = du[~flip]
    return {"flip_share": float(flip.mean()), "flips": int(flip.sum()),
            "max_du": float(rest.max()) if rest.size else 0.0}


def flow_agreement(flow, ref, gt, valid) -> dict:
    """Flow on the card vs the CPU run of the same code: both EPEs to
    the known motion and the share of pixels differing > DIFF_PX."""
    flow, ref, gt = (np.asarray(x, np.float64) for x in (flow, ref, gt))
    if not (np.isfinite(flow).all() and flow.shape == ref.shape):
        raise AssertionError("card flow non-finite or misshapen")
    epe = lambda f: float(np.linalg.norm(f - gt, axis=-1)[valid].mean())
    diff = np.linalg.norm(flow - ref, axis=-1)
    return {"epe": epe(flow), "epe_cpu": epe(ref),
            "diff_share": float((diff > DIFF_PX).mean()),
            "max_diff": float(diff.max())}


def _gate(name, ok, detail):
    log(f"  {name}: {detail}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def _precision_scan(lowered_text: str) -> dict:
    """Every f32 dot_general / convolution must request HIGHEST: on
    this card the default precision of an f32 product may be TF32."""
    import re

    ops = re.findall(r"stablehlo\.(?:dot_general|convolution)[^\n]*",
                     lowered_text)
    low = [o for o in ops if "HIGHEST" not in o]
    return {"dot_conv": len(ops), "below_highest": len(low)}


def _cfgs():
    from dis_tpu.config import DIS_FAST, DIS_MEDIUM, DISConfig

    compat = DISConfig(iterations=16, patch_size=8, coarsest_scale=3,
                       finest_scale=0, patch_overlap=0.3, mode="compat",
                       early_exit=False)     # bench.py's configuration
    return compat, DIS_FAST, DIS_MEDIUM


def _cfg(name):
    compat, fast, medium = _cfgs()
    return {"compat": compat, "fast": fast, "medium": medium}[name]


def phase_kernels(card_name, cpu):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from dis_tpu.models.dis import _fixed_weights
    from dis_tpu.ops import iclk
    from dis_tpu.ops.densify import densify
    from dis_tpu.ops.grid import make_grid
    from dis_tpu.ops.pyramid import construct_pyramid
    from dis_tpu.ops.variational import variational_refinement
    from dis_tpu.utils import synth

    compat, fast, medium = _cfgs()
    i1, i2, _, _ = synth.translation(*FRAME_1080, seed=11)
    pyr_jit = jax.jit(lambda x: construct_pyramid(x, 3, 8))

    def pyr(x):   # level sizes come back from jit as arrays: make static
        return [lv._replace(width=int(lv.width), height=int(lv.height))
                for lv in pyr_jit(x)]

    p1 = pyr(jnp.asarray(i1))
    p2 = pyr(jnp.asarray(i2))
    on_cpu = lambda xs: jax.device_put(xs, cpu)

    # Triton search vs XLA search (direct sampler), same inputs, on card
    rng = np.random.default_rng(5)
    for scale in (0, 3):
        l1, l2 = p1[scale], p2[scale]
        geom = make_grid(l1.width, l1.height, compat.steps)
        centers = jnp.asarray(geom.centers)
        init = (jnp.zeros_like(centers) if scale == 3 else jnp.asarray(
            rng.uniform(-2, 2, centers.shape).astype(np.float32)))
        for mode in ("compat", "fixed"):
            cfg = dataclasses.replace(compat, mode=mode, sampler="global")
            tpl = jax.jit(lambda a, b, c: iclk.extract_templates_grid(
                a, b, c, geom, 8, 8))(l1.img, l1.dx, l1.dy)

            def search(kernel):
                c = dataclasses.replace(cfg, kernel=kernel)
                f = jax.jit(lambda img, t, iu: iclk.inverse_search(
                    img, t, centers, iu, c, l1.width, l1.height))
                r = f(l2.img, tpl, init)
                jax.block_until_ready(r)
                t0 = time.perf_counter()
                for _ in range(5):
                    r = jax.block_until_ready(f(l2.img, tpl, init))
                return r, (time.perf_counter() - t0) / 5 * 1e3

            (rt, ms_t), (rx, ms_x) = search("pallas"), search("xla")
            a = search_agreement(rt.u, rt.converged, rx.u, rx.converged)
            _gate(f"search s{scale} {mode} n={centers.shape[0]}",
                  a["flip_share"] <= SEARCH_FLIP_MAX,
                  f"{a['flips']} decision flips, share "
                  f"{a['flip_share']:.5f} (limit {SEARCH_FLIP_MAX}); others "
                  f"max |du| {a['max_du']:.2e} px (limit {SEARCH_U_TOL}); "
                  f"triton {ms_t:.3f} ms, xla {ms_x:.3f} ms on {card_name}")

    # pyramid planes: card vs host CPU on the same input
    got = pyr(jnp.asarray(i1))
    want = pyr(on_cpu(jnp.asarray(i1)))
    for s, (g, w) in enumerate(zip(got, want)):
        for k in ("img", "dx", "dy"):
            check_close(f"pyramid s{s} {k}", getattr(g, k), getattr(w, k))

    # templates, densify: identical inputs on both devices
    l1 = p1[0]
    geom = make_grid(l1.width, l1.height, fast.steps)
    tfn = jax.jit(lambda a, b, c: iclk.extract_templates_grid(
        a, b, c, geom, 8, 8))
    tg = tfn(l1.img, l1.dx, l1.dy)
    tc = tfn(*on_cpu((l1.img, l1.dx, l1.dy)))
    for k in ("T", "Tdx", "Tdy", "Hinv"):
        check_close(f"templates {k}", getattr(tg, k), getattr(tc, k))
    res = jax.jit(lambda img, t: iclk.inverse_search(
        img, t, jnp.asarray(geom.centers), jnp.zeros((geom.num_w *
                                                      geom.num_h, 2)),
        fast, l1.width, l1.height))(p2[0].img, tg)
    wts = jax.jit(lambda r, t: _fixed_weights(r, t, fast))(res, tg)
    dfn = jax.jit(lambda u, w: densify(u, geom, l1.width, l1.height, 8, w))
    check_close("densify", dfn(res.u, wts), dfn(*on_cpu((res.u, wts))))

    # one refinement level (DIS_MEDIUM's paper form) at scale 2
    l1, l2 = p1[2], p2[2]
    flow0 = jnp.asarray(rng.uniform(-1, 1, (l1.height, l1.width, 2))
                        .astype(np.float32))
    rfn = jax.jit(lambda a, b, f: variational_refinement(a, b, f, medium))
    check_close("refinement s2", rfn(l1.img, l2.img, flow0),
                rfn(*on_cpu((l1.img, l2.img, flow0))))


def phase_end_to_end(card_name, cpu) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from dis_tpu.models.dis import dis_flow
    from dis_tpu.utils import synth

    out = {}
    for name, cfg_name, (h, w) in E2E:
        cfg = _cfg(cfg_name)
        i1, i2, gt, valid = synth.translation(h, w, seed=0)
        a, b = jnp.asarray(i1), jnp.asarray(i2)
        f = jax.jit(lambda x, y: dis_flow(x, y, cfg))
        t0 = time.perf_counter()
        lowered = f.lower(a, b)
        prec = _precision_scan(lowered.as_text())
        compiled = lowered.compile()
        compile_s = time.perf_counter() - t0
        flow = jax.block_until_ready(compiled(a, b))
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            flow = jax.block_until_ready(compiled(a, b))
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        mem = compiled.memory_analysis()
        cfg_cpu = dataclasses.replace(cfg, kernel="xla")
        ref = jax.jit(lambda x, y: dis_flow(x, y, cfg_cpu))(
            jax.device_put(a, cpu), jax.device_put(b, cpu))
        agr = flow_agreement(flow, ref, gt, valid)
        log(f"  {name}: compile {compile_s:.1f} s, {ms:.3f} ms/frame "
            f"median of 5 on {card_name}; memory: args "
            f"{mem.argument_size_in_bytes / 2**20:.1f} MiB, temp "
            f"{mem.temp_size_in_bytes / 2**20:.1f} MiB, out "
            f"{mem.output_size_in_bytes / 2**20:.1f} MiB; dot/conv "
            f"{prec['dot_conv']} ({prec['below_highest']} below HIGHEST)")
        _gate(f"{name} vs cpu",
              abs(agr["epe"] - agr["epe_cpu"]) <= EPE_TOL
              and agr["diff_share"] < DIFF_SHARE_MAX
              and prec["below_highest"] == 0,
              f"EPE {agr['epe']:.4f} (cpu {agr['epe_cpu']:.4f}, limit "
              f"+-{EPE_TOL}), {agr['diff_share']:.5f} of pixels differ "
              f"> {DIFF_PX} px (limit {DIFF_SHARE_MAX}), max "
              f"{agr['max_diff']:.3e} px")
        out[name] = (i1, i2, np.asarray(flow))
    return out


def phase_serving(e2e) -> None:
    import tempfile

    from dis_tpu import cli, runner, serving
    from dis_tpu.config import DIS_FAST
    from dis_tpu.utils import flo, synth
    from dis_tpu.utils import io as uio

    h, w = SINTEL
    i1, i2, want = e2e[E2E[1][0]]
    cf = serving.aot_compile(DIS_FAST, h, w)
    flows = [np.asarray(cf(i1, i2))]
    for seed in (1, 2):
        a, b, _, _ = synth.translation(h, w, seed=seed)
        flows.append(np.asarray(cf(a, b)))
    _gate("aot_compile 3 requests",
          all(f.shape == (h, w, 2) and np.isfinite(f).all()
              for f in flows) and np.array_equal(flows[0], want),
          f"finite [{h},{w},2] flows; request 1 equals the jitted "
          "dis_flow bitwise")
    exp = serving.export_flow(DIS_FAST, h, w)
    artifacts = [("in memory", exp)]
    # Exported.serialize() needs JAX's optional flatbuffers package
    if importlib.util.find_spec("flatbuffers") is not None:
        artifacts.append(("serialized", exp.serialize()))
    for kind, art in artifacts:
        run, _ = serving.load_exported(art)
        got = np.asarray(run(i1, i2))
        _gate(f"export_flow -> load_exported ({kind})",
              np.array_equal(got, flows[0]),
              f"max |d| vs aot {np.abs(got - flows[0]).max():.3e}")

    with tempfile.TemporaryDirectory() as td:
        folder = os.path.join(td, "clip")
        os.makedirs(folder)
        r = np.random.default_rng(7)
        from scipy.signal import convolve2d

        big = convolve2d(r.random((h + 24, w + 36)) * 255,
                         np.ones((5, 5)) / 25, "same", "symm")
        for t in range(4):   # frame t+1 = frame t moved by (+2, +1) px
            fr = big[12 - t:12 - t + h, 24 - 2 * t:24 - 2 * t + w]
            uio.imwrite(os.path.join(folder, f"frame_{t + 1:04d}.png"),
                        np.clip(fr, 0, 255).astype(np.uint8))
        out_r = os.path.join(td, "runner")
        s = runner.run_sequence(folder, 1, 4, DIS_FAST, out_dir=out_r,
                                save_flo=True)
        out_c = os.path.join(td, "cli")
        rc = cli.main([folder, "1", "4", "--preset", "fast", "--save-flo",
                       "--out-dir", out_c])
        for t in range(1, 4):
            fr = flo.load_flo(os.path.join(out_r, f"frame_{t:04d}.flo"))
            fc = flo.load_flo(os.path.join(out_c, f"frame_{t:04d}.flo"))
            med = np.median(fr.reshape(-1, 2), axis=0)
            _gate(f"runner/cli pair {t}",
                  rc == 0 and s["pairs_done"] == 3
                  and fr.shape == (h, w, 2)
                  and np.array_equal(fr, fc)
                  and np.abs(med - [2.0, 1.0]).max() < 0.25,
                  f"median flow {med.round(3).tolist()} (shift [2, 1]); "
                  f"runner == cli bitwise")
    loaded = sorted(m for m in ("PIL", "imageio") if m in sys.modules)
    _gate("no imaging library loaded", not loaded, f"loaded: {loaded}")


def phase_batched() -> None:
    import jax
    import jax.numpy as jnp

    from dis_tpu.models.dis import dis_flow
    from dis_tpu.utils import synth

    _, fast, medium = _cfgs()
    pairs = [synth.translation(*SINTEL, seed=s)[:2] for s in (3, 4)]
    a = jnp.asarray(np.stack([p[0] for p in pairs]))
    b = jnp.asarray(np.stack([p[1] for p in pairs]))
    for name, cfg in (("DIS_FAST", fast), ("DIS_MEDIUM", medium)):
        one = jax.jit(lambda x, y: dis_flow(x, y, cfg))
        many = np.asarray(jax.jit(jax.vmap(one))(a, b))
        d = max(float(np.abs(many[k] - np.asarray(one(a[k], b[k]))).max())
                for k in range(2))
        _gate(f"vmap batch-2 == serial, Sintel {name}", d == 0.0,
              f"max |d| {d:.3e}")


def phase_four_cards(devs) -> None:
    import jax
    import jax.numpy as jnp

    from dis_tpu.models.dis import dis_flow_padded
    from dis_tpu.parallel import (batched_flow_fn, make_mesh,
                                  sequence_flow_fn, tiled_flow_fn)
    from dis_tpu.utils import synth

    _, fast, medium = _cfgs()

    def single(cfg):
        return jax.jit(lambda x, y: dis_flow_padded(x, y, cfg))

    failed = []

    def bitwise(name, got, want, t0):
        # every engine is compared and reported; the phase fails at the
        # end if any differs
        d = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        log(f"  {name}: max |d| vs one card {d:.3e}, "
            f"{float(np.mean(np.asarray(got) != np.asarray(want))):.2e} "
            f"of values differ; {time.perf_counter() - t0:.1f} s")
        if d != 0.0:
            failed.append(name)

    t0 = time.perf_counter()
    pairs = [synth.translation(*KITTI, seed=s)[:2] for s in range(4)]
    a = jnp.asarray(np.stack([p[0] for p in pairs]))
    b = jnp.asarray(np.stack([p[1] for p in pairs]))
    got = batched_flow_fn(fast, make_mesh((4, 1), devices=devs))(a, b)
    ref = single(fast)
    bitwise("batched_flow_fn KITTI x4 pairs", got,
            np.stack([np.asarray(ref(a[k], b[k])) for k in range(4)]), t0)

    smesh = make_mesh((1, 4), axis_names=("batch", "space"), devices=devs)
    h, w = FRAME_1080
    i1, i2, _, _ = synth.translation(h, w, seed=1)
    a, b = jnp.asarray(i1), jnp.asarray(i2)
    for name, cfg in ((f"tiled_flow_fn {h}x{w} space=4 DIS_FAST", fast),
                      (f"grid-tiled {h}x{w} space=4 DIS_MEDIUM", medium)):
        t0 = time.perf_counter()
        got = tiled_flow_fn(cfg, smesh, h, w)(a, b)
        bitwise(name, got, single(cfg)(a, b), t0)

    t0 = time.perf_counter()
    r = np.random.default_rng(2)
    from scipy.signal import convolve2d

    h, w = CLIP
    big = convolve2d(r.random((h + 40, w + 56)) * 255, np.ones((5, 5)) / 25,
                     "same", "symm").astype(np.float32)
    clip = jnp.asarray(np.stack(
        [big[16 - t:16 - t + h, 32 - 2 * t:32 - 2 * t + w]
         for t in range(8)]))
    got = sequence_flow_fn(fast, make_mesh((4,), axis_names=("seq",),
                                           devices=devs))(clip)
    ref = single(fast)
    bitwise("sequence_flow_fn 8 frames", np.asarray(got)[:7],
            np.stack([np.asarray(ref(clip[t], clip[t + 1]))
                      for t in range(7)]), t0)
    if failed:
        raise AssertionError(f"not bitwise equal to one card: {failed}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card engines, on 4 cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform!r} devices")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from timing import card, parse_card

    from dis_tpu.backend import setup_compile_cache

    t_start = time.perf_counter()
    with phase("1 device"):
        line = card()
        c = parse_card(line)
        card_name = f"{c['name']} @ {c['power_limit']}"
        log(line)
        log(f"  jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
        log(f"  compile cache: {setup_compile_cache()}")
        cpu = jax.devices("cpu")[0]
        need = 4 if args.four_cards else 1
        if len(devs) < need:
            raise SystemExit(f"need {need} GPUs, found {len(devs)}")
        devs = devs[:need]

    if args.four_cards:
        with phase("four cards: engines vs one card"):
            phase_four_cards(devs)
    else:
        with phase("2 kernels vs plain reference"):
            phase_kernels(card_name, cpu)
        with phase("3 end to end vs cpu"):
            e2e = phase_end_to_end(card_name, cpu)
        with phase("4 serving and host paths"):
            phase_serving(e2e)
        with phase("5 batched"):
            phase_batched()
    log(f"total {time.perf_counter() - t_start:.1f} s on {card_name}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
