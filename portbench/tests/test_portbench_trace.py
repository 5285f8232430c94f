"""The trace arithmetic on a synthetic Chrome trace: busy time as the
union of device intervals inside the traced stretch, the idle share, time
by kernel name, and idle gaps labelled by the innermost host event."""

import json

import pytest

from portbench import trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _ev("user_annotation", trace.UNIT_RANGE, 100, 100),   # stretch 100-200
    _ev("kernel", "conv", 90, 20),          # 90-110, clipped to 100-110
    _ev("kernel", "conv", 105, 15),         # overlaps: union 100-120
    _ev("kernel", "gemm", 150, 10),         # 150-160
    _ev("gpu_memcpy", "Memcpy DtoH", 175, 5),   # 175-180
    _ev("gpu_memset", "Memset", 178, 4),    # 178-182: union 175-182
    _ev("kernel", "late", 230, 10),         # outside the stretch
    _ev("gpu_user_annotation", "portbench/unit", 100, 100),  # not a kernel
    _ev("cpu_op", "aten::copy_", 125, 20),  # covers the 120-150 gap's middle
    _ev("user_annotation", "engine/match_forward", 100, 100),
    _ev("cuda_runtime", "cudaStreamSynchronize", 183, 16),
]


def test_busy_idle_and_kernels():
    s = trace.summarize(EVENTS)
    assert s.window_s == pytest.approx(100e-6)
    # union: 100-120, 150-160, 175-182 = 37 us
    assert s.busy_s == pytest.approx(37e-6)
    assert s.idle_pct == pytest.approx(63.0)
    assert s.kernel_s["conv"] == pytest.approx(25e-6)   # 10 + 15
    assert s.kernel_s["gemm"] == pytest.approx(10e-6)
    assert "late" not in s.kernel_s
    assert s.seconds_of("conv", "gemm") == pytest.approx(35e-6)
    assert s.top_ops(2) == [("conv", pytest.approx(25e-6)),
                            ("gemm", pytest.approx(10e-6))]


def test_gaps_longest_first_with_host_labels():
    s = trace.summarize(EVENTS)
    # holes: 120-150 (30), 160-175 (15), 182-200 (18)
    assert [round(g * 1e6) for _, g in s.gaps] == [30, 18, 15]
    assert s.gaps[0][0] == "aten::copy_"             # innermost at 135
    assert s.gaps[1][0] == "cudaStreamSynchronize"   # at 191
    assert s.gaps[2][0] == "engine/match_forward"    # only the range


def test_read_from_file(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    assert trace.read(str(p)).busy_s == pytest.approx(37e-6)


def test_no_unit_range_is_an_error():
    with pytest.raises(ValueError):
        trace.summarize(EVENTS[1:])


def test_merge():
    assert trace.merge([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
