"""chip_smoke.py's CPU-testable parts: the comparison helpers, the
nvidia-smi line parser, the precision scan, and that without a GPU (or
without the rest of the repository) it exits nonzero with no result."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import chip_smoke  # noqa: E402
from timing import parse_card  # noqa: E402


def test_rel_err_is_relative_to_reference_scale():
    want = np.array([0.0, 100.0, -50.0])
    got = want + np.array([1e-4, 0.0, -2e-4])
    assert chip_smoke.rel_err(got, want) == pytest.approx(2e-6, rel=1e-3)
    assert chip_smoke.rel_err(want, want) == 0.0
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.rel_err(want[:2], want)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.rel_err(np.array([np.nan, 0, 0]), want)
    chip_smoke.check_close("same", want, want)
    with pytest.raises(AssertionError):
        chip_smoke.check_close("off", want * 1.001, want)


def test_search_agreement_counts_flips_and_du():
    u_a = np.zeros((5, 2), np.float32)
    u_b = u_a.copy()
    u_b[0] = [3e-4, 0]
    u_b[2] = [2.0, 0.0]            # reset by policing in one search only
    u_b[3] = [5.0, 5.0]            # its freeze flag flipped
    conv_a = np.array([True, False, True, True, False])
    conv_b = np.array([True, False, True, False, False])
    a = chip_smoke.search_agreement(u_a, conv_a, u_b, conv_b)
    assert a["flips"] == 2 and a["flip_share"] == 0.4
    assert a["max_du"] == pytest.approx(3e-4)


def test_flow_agreement():
    gt = np.zeros((4, 5, 2))
    gt[..., 0] = 2.0
    ref = gt + 0.1
    flow = ref.copy()
    flow[0, 0, 0] += 0.5
    valid = np.ones((4, 5), bool)
    a = chip_smoke.flow_agreement(flow, ref, gt, valid)
    assert a["diff_share"] == pytest.approx(1 / 20)
    assert a["epe_cpu"] == pytest.approx(np.sqrt(0.02))
    assert a["epe"] > a["epe_cpu"]
    with pytest.raises(AssertionError):
        chip_smoke.flow_agreement(flow * np.nan, ref, gt, valid)


def test_parse_card():
    c = parse_card("NVIDIA H100 80GB HBM3, 700.00 W\n")
    assert c == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    with pytest.raises(ValueError):
        parse_card("garbage")


def test_precision_scan():
    txt = ("%0 = stablehlo.dot_general %a, %b, precision = [HIGHEST, "
           "HIGHEST] : ...\n%1 = stablehlo.convolution(%c, %d) ... \n"
           "%2 = stablehlo.add %0, %0\n")
    assert chip_smoke._precision_scan(txt) == {"dot_conv": 2,
                                               "below_highest": 1}


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_exits_nonzero_without_gpu():
    r = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
