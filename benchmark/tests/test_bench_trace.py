"""The program's spans read against a device trace (benchmark/program_spans.py):
on synthetic events, a device activity is credited, through its launch
call's correlation id, to the innermost span open when that call started
(not when the activity ran), and an idle gap is named by the innermost
span at its middle and by what benchmark/trace.py names it; and the tool
on each cell at test size, on the CPU."""

from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from benchmark import program_spans, trace
from benchmark.program_spans import Spans
from benchmark.tests.small import SEED, small_spec
from slam_plus_plus_tpu_torch.utils.timer import SpanRecord

ANCHOR = 10_000          # unix ns = perf-counter ns + ANCHOR


class Ev:
    def __init__(self, name, start, dur, corr, device=False):
        self._n, self._s, self._d, self._c = name, start, dur, corr
        self._t = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._t


def _program():
    # R [0, 1000] holds A [100, 400] and B [500, 900]; B holds B1 [600, 700]
    spans = [SpanRecord("A", 2, 1, 1, 100, 400, {}),
             SpanRecord("B1", 4, 3, 1, 600, 700, {"level": 0}),
             SpanRecord("B", 3, 1, 1, 500, 900, {}),
             SpanRecord("R", 1, 0, 1, 0, 1000, {})]
    return Spans({"spans": spans, "counts": [], "anchor_ns": (ANCHOR, ANCHOR)})


def _events():
    u = ANCHOR
    return [
        Ev("cudaLaunchKernel", u + 0, 10, 1),          # in R only
        Ev("k0", u + 20, 10, 1, device=True),
        Ev("cudaLaunchKernel", u + 150, 10, 7),        # in A
        Ev("k7", u + 200, 100, 7, device=True),
        Ev("cudaLaunchKernel", u + 550, 10, 9),        # in B
        Ev("aten::mm", u + 640, 5, 8),                 # a host op's id, not a launch's
        Ev("cudaLaunchKernel", u + 650, 10, 8),        # in B1
        Ev("k8", u + 800, 50, 8, device=True),         # runs after B1 has ended
        Ev("k9", u + 860, 20, 9, device=True),
    ]


def test_kernels_credited_through_their_launch_call():
    tr = program_spans.attribute(_events(), _program())
    assert tr.n_device == tr.n_linked == tr.n_credited == 4
    got = {k: round(v * 1e9) for k, v in tr.span_dev_s.items()}
    assert got == {"R": 180, "A": 100, "B": 70, "B1": 50}
    assert tr.span_dev_n == {"R": 4, "A": 1, "B": 2, "B1": 1}
    assert tr.span_calls == {"R": 1, "A": 1, "B": 1, "B1": 1}


def test_gaps_named_by_the_innermost_span_at_their_middle():
    tr = program_spans.attribute(_events(), _program())
    sep, own = program_spans.SEP, trace.HOST_OWN
    got = {k: round(v * 1e9) for k, v in tr.gaps_s.items()}
    assert got == {f"R{sep}cudaLaunchKernel": 20,      # [0, 20], mid 10: R's launch
                   f"A{sep}{own}": 170,                 # [30, 200], mid 115
                   f"B{sep}cudaLaunchKernel": 500,      # [300, 800], mid 550
                   f"B{sep}{own}": 10}                  # [850, 860]
    assert tr.idle_s * 1e9 == pytest.approx(700)
    assert tr.idle_below_root_s * 1e9 == pytest.approx(680)


def test_gaps_named_as_the_trace_names_them():
    """Less its span, each gap's name and idle time are trace.summarize's."""
    plain = trace.summarize(_events())
    spanned = program_spans.attribute(_events(), _program())
    calls = {}
    for name, sec in spanned.gaps_s.items():
        call = name.split(program_spans.SEP)[-1]
        calls[call] = calls.get(call, 0.0) + sec
    assert calls.keys() == plain.gaps_s.keys()
    for call, sec in plain.gaps_s.items():
        assert calls[call] == pytest.approx(sec)
    assert spanned.n_device == plain.n_device


@pytest.mark.parametrize("cell", ["manhattan3500.fastl", "ring871.batch"])
def test_tool_runs_on_cpu(tmp_path, cell, capsys):
    """Without a card the spans-on units still give the host readings:
    FastL's solve points, one span each; no device reading."""
    r = program_spans.profile_cell(small_spec(tmp_path), cell, SEED, "cpu")
    assert r["spans_a_unit"] > 0 and r["credited_pct"] == {}
    if cell == "manhattan3500.fastl":
        assert set(r["readings"]) == {"solve_point_p95_ms.inc", "solve_point_host_ms.inc"}
        assert all(v > 0 for v in r["readings"].values())
        assert r["solve_points"] > 0
    else:
        assert r["readings"] == {} and r["solve_points"] == 0
    assert "program spans" in capsys.readouterr().err
