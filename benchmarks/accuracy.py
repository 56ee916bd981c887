#!/usr/bin/env python
"""Accuracy-parity harness: JAX pipeline vs C++ baseline vs NumPy oracle.

BASELINE.json demands EPE parity "with the reference implementation";
with no Sintel/KITTI data shipped in this environment, parity is scored
against the two independent re-implementations of the reference
semantics (the C++ baseline in tools/cpp_baseline and the NumPy oracle)
on synthetic pairs with known ground truth, at several sizes/configs.

Usage:  python benchmarks/accuracy.py [--sizes small|full]
Outputs a JSON summary: per-config EPE of each implementation vs ground
truth and the cross-implementation flow deltas.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dis_tpu.config import DISConfig  # noqa: E402
from dis_tpu.oracle import reference_semantics as spec  # noqa: E402
from dis_tpu.utils.metrics import epe  # noqa: E402

TOOL_DIR = os.path.join(ROOT, "tools", "cpp_baseline")
BIN = os.path.join(TOOL_DIR, "dis_baseline")

REF_DIR = os.path.join(ROOT, "tools", "ref_build")
REF_BIN = os.path.join(REF_DIR, "ref_probe")
ZERONEW = os.path.join(REF_DIR, "zeronew.so")


def synthetic_pair(h, w, shift, seed):
    from scipy.signal import convolve2d
    r = np.random.default_rng(seed)
    big = (r.random((h + 32, w + 32)) * 255).astype(np.float32)
    k = np.ones((7, 7), np.float32) / 49.0
    big = convolve2d(big, k, "same", "symm").astype(np.float32)
    big = convolve2d(big, k, "same", "symm").astype(np.float32)
    dx, dy = shift
    i1 = big[16:16 + h, 16:16 + w]
    i2 = big[16 - dy:16 - dy + h, 16 - dx:16 - dx + w]
    return np.ascontiguousarray(i1), np.ascontiguousarray(i2)


def run_cpp(i1, i2, cfg):
    if not os.path.exists(BIN):
        subprocess.run(["make", "-C", TOOL_DIR], check=True, capture_output=True)
    h, w = i1.shape
    with tempfile.TemporaryDirectory() as td:
        p1, p2, po = (os.path.join(td, n) for n in ("a.f32", "b.f32", "o.f32"))
        i1.astype("<f4").tofile(p1)
        i2.astype("<f4").tofile(p2)
        subprocess.run(
            [BIN, str(w), str(h), str(cfg.iterations), str(cfg.patch_size),
             str(cfg.coarsest_scale), str(cfg.finest_scale),
             str(cfg.patch_overlap), str(int(cfg.patch_normalization)), "1",
             p1, p2, po],
            check=True, capture_output=True, timeout=1800)
        return np.fromfile(po, dtype="<f4").reshape(h, w, 2)


def run_reference(i1, i2, cfg, zero_init: bool = True):
    """Run the ACTUAL reference core (unmodified /root/reference sources
    linked by tools/ref_build/ref_probe) on raw f32 inputs and return
    the flow, or None when the binary can't be built (e.g. OpenCV dev
    headers absent).  ``zero_init=True`` preloads zeronew.so to pin
    quirk Q2 (uninitialized densification weights) to its evident
    intent; False runs the UB as-is."""
    if not os.path.exists(REF_BIN):
        try:
            subprocess.run(["make", "-C", REF_DIR], check=True,
                           capture_output=True, timeout=600)
        except Exception:
            return None
    h, w = i1.shape
    env = dict(os.environ)
    if zero_init:
        env["LD_PRELOAD"] = ZERONEW
    with tempfile.TemporaryDirectory() as td:
        p1, p2, po = (os.path.join(td, n) for n in ("a.f32", "b.f32", "o.flo"))
        i1.astype("<f4").tofile(p1)
        i2.astype("<f4").tofile(p2)
        subprocess.run(
            [REF_BIN, str(w), str(h), str(cfg.iterations),
             str(cfg.patch_size), str(cfg.coarsest_scale),
             str(cfg.finest_scale), str(cfg.patch_overlap),
             str(int(cfg.patch_normalization)), p1, p2, po],
            check=True, capture_output=True, timeout=1800, env=env)
        from dis_tpu.utils.flo import load_flo
        return load_flo(po)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", choices=["small", "full"], default="small")
    ap.add_argument("--out", default=None,
                    help="also write the JSON records to this file "
                         "(per-round committed parity artifact)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from dis_tpu.models.dis import dis_flow_padded
    from dis_tpu.utils.synth import FAMILIES, masked_epe

    # Motion-family grid (VERDICT round-1 item #5): >=6 families at >=2
    # sizes, same <0.1 px EPE-delta gate vs the C++ reference semantics.
    if args.sizes == "small":
        dims = [(128, 96), (192, 128)]
        cfg = DISConfig(iterations=16, coarsest_scale=2, patch_overlap=0.5)
    else:
        dims = [(512, 384), (1024, 440)]
        cfg = DISConfig(iterations=16, coarsest_scale=3, patch_overlap=0.3)

    results = []
    for (w, h) in dims:
        for family, gen in sorted(FAMILIES.items()):
            i1, i2, gt, valid = gen(h, w)
            ours = np.asarray(dis_flow_padded(
                jnp.asarray(i1), jnp.asarray(i2), cfg))
            cpp = run_cpp(i1, i2, cfg)
            orc = spec.dis_flow_oracle(i1, i2, cfg)
            ref = run_reference(i1, i2, cfg)          # actual reference core
            ref_ub = run_reference(i1, i2, cfg, zero_init=False)

            m = 12  # borders are unconstrained for any local method
            sl = np.s_[m:-m, m:-m]
            rec = {
                "family": family, "size": f"{w}x{h}",
                "iters": cfg.iterations, "overlap": cfg.patch_overlap,
                "platform": jax.default_backend(),
                "epe_tpu": round(masked_epe(ours, gt, valid, m), 4),
                "epe_cpp": round(masked_epe(cpp, gt, valid, m), 4),
                "epe_oracle": round(masked_epe(orc, gt, valid, m), 4),
                "delta_tpu_vs_cpp": round(
                    float(np.abs(ours[sl] - cpp[sl]).mean()), 5),
                "delta_tpu_vs_oracle": round(
                    float(np.abs(ours[sl] - orc[sl]).mean()), 5),
            }
            if ref is not None:
                rec["epe_ref"] = round(masked_epe(ref, gt, valid, m), 4)
                rec["delta_tpu_vs_ref"] = round(
                    float(np.abs(ours[sl] - ref[sl]).mean()), 5)
                rec["delta_ref_vs_oracle"] = round(
                    float(np.abs(ref[sl] - orc[sl]).mean()), 5)
            if ref_ub is not None:
                # the as-is binary (quirk Q2's uninitialized weights LIVE)
                rec["epe_ref_asis_ub"] = round(
                    masked_epe(ref_ub, gt, valid, m), 4)
            results.append(rec)
            print(json.dumps(rec), flush=True)

    # Pass criterion: ACCURACY parity (|EPE difference| vs the C++
    # reference semantics).  The raw flow-field delta is reported but
    # not gated: the IC-LK loop is a chaotic fixed-point iteration and
    # hardware fp differences (fused multiplies, sqrt rounding) flip
    # the outlier-policing decision for near-threshold patches,
    # perturbing a subset of patch flows without hurting accuracy.
    worst_epe = max(abs(r["epe_tpu"] - r["epe_cpp"]) for r in results)
    worst_delta = max(r["delta_tpu_vs_cpp"] for r in results)
    summary = {"summary": "parity", "sizes": args.sizes,
               "families": len(FAMILIES), "cases": len(results),
               "max_abs_epe_diff_vs_cpp": round(worst_epe, 4),
               "max_mean_flow_delta_vs_cpp": worst_delta,
               "pass": bool(worst_epe < 0.1)}
    with_ref = [r for r in results if "epe_ref" in r]
    if with_ref:
        worst_ref = max(abs(r["epe_tpu"] - r["epe_ref"]) for r in with_ref)
        summary["max_abs_epe_diff_vs_actual_reference"] = round(worst_ref, 4)
        summary["max_mean_flow_delta_vs_actual_reference"] = max(
            r["delta_tpu_vs_ref"] for r in with_ref)
        summary["pass"] = bool(summary["pass"] and worst_ref < 0.1)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"records": results, **summary}, f, indent=1)


if __name__ == "__main__":
    main()
