"""tools/trace_budget.py's reducer on a small hand-written trace: device
plane selection, busy/idle union, per-layer attribution from the saved
HLO metadata, and a trace with no GPU plane refused."""

import gzip
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import trace_budget  # noqa: E402


def _write(tmp_path, events, procs, threads, hlo=None):
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    meta = ([{"ph": "M", "name": "process_name", "pid": p,
              "args": {"name": n}} for p, n in procs.items()]
            + [{"ph": "M", "name": "thread_name", "pid": p, "tid": t,
                "args": {"name": n}} for (p, t), n in threads.items()])
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": meta + events}, f)
    if hlo is not None:
        (tmp_path / "hlo.txt").write_text(hlo)
    return str(tmp_path)


def _x(name, ts, dur, pid=1, tid=7):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid}


def test_reduces_device_streams_per_layer(tmp_path):
    hlo = ('  %loop_add_fusion.3 = f32[8] fusion(%a), kind=kLoop, '
           'metadata={op_name="jit(f)/pyramid/add"}\n'
           '  ROOT %input_reduce_fusion = f32[] fusion(%b), '
           'metadata={op_name="jit(f)/scale_0/reduce_sum"}\n'
           '  %loop_select_fusion.2 = f32[8] fusion(%c), '
           'metadata={op_name="jit(f)/scale_1/refine_s1/select_n"}\n')
    events = [
        _x("loop_add_fusion_3", 0, 100),
        _x("iclk_search__2", 150, 200),
        _x("input_reduce_fusion", 300, 100),     # overlaps the search
        _x("loop_select_fusion_2", 350, 50),
        _x("loop_add_fusion_3", 1000, 100, tid=8),  # derived line: dropped
        _x("host_op", 0, 5000, pid=2, tid=1),       # host plane: dropped
    ]
    d = _write(tmp_path, events,
               {1: "/device:GPU:0", 2: "/host:CPU"},
               {(1, 7): "Stream #13(Compute)", (1, 8): "XLA Ops",
                (2, 1): "python"}, hlo)
    s = trace_budget.summarize(d, frames=1)
    assert s["kernel_ms_per_frame"] == pytest.approx(0.45)
    assert s["busy_ms_per_frame"] == pytest.approx(0.35)
    assert s["window_ms_per_frame"] == pytest.approx(0.4)
    assert s["idle_share"] == pytest.approx(0.125)
    assert s["layers_ms_per_frame"] == pytest.approx(
        {"iclk_search": 0.2, "pyramid": 0.1, "scale_0": 0.1,
         "refine_s1": 0.05})


def test_refuses_trace_without_gpu_plane(tmp_path):
    d = _write(tmp_path, [_x("op", 0, 1)], {1: "/host:CPU"},
               {(1, 7): "Stream #1"})
    with pytest.raises(SystemExit, match="no GPU device plane"):
        trace_budget.summarize(d, frames=1)
