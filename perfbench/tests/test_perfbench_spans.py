"""The reading of the program's own spans (``perfbench/spans.py``) on
recorded timelines and records: launches booked to the span that made
them from any thread, collectives on the wall clock, the wait of one rank
for the others, the phases of recorded steps, and the readings."""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import spans

ROOT = Path(__file__).resolve().parents[2]


def _ev(name, start, end, device, thread=1, annotation=False, dev_us=0.0):
    return SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        thread=thread, device_time_total=dev_us,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def _launch(name, start, end, cid, thread=1):
    return SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CPU,
        is_user_annotation=False, thread=thread, id=cid,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def _span(name, start, end, thread=1):
    return _ev(name, start, end, torch.autograd.DeviceType.CPU,
               thread=thread, annotation=True)


def _kernel(name, start, end, cid):
    e = _ev(name, start, end, torch.autograd.DeviceType.CUDA)
    e.id = cid
    return e


def test_program_spans_book_launches_from_any_thread():
    cpu = torch.autograd.DeviceType.CPU
    events = [
        _span("hvd.step", 0, 100), _span("hvd.forward", 0, 30),
        _span("hvd.backward", 30, 70), _span("hvd.sync_grads", 70, 90),
        _span("hvd.optimizer", 90, 100),
        _launch("cudaLaunchKernel", 10, 11, 1),
        _ev("aten::item", 20, 25, cpu),
        _ev("aten::_local_scalar_dense", 21, 25, cpu),
        _launch("cudaStreamSynchronize", 22, 24, 2),
        # backward launches from autograd's thread
        _launch("cudaLaunchKernel", 40, 41, 3, thread=2),
        _launch("cuLaunchKernelEx", 80, 81, 4),
        _launch("cudaLaunchKernel", 95, 96, 5),
        _launch("cudaLaunchKernel", 120, 121, 6),      # after the step
        _kernel("gemm", 12, 30, 1), _kernel("gelu_bwd", 42, 50, 3),
        _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 82, 88, 4),
        _kernel("adam", 96, 99, 5), _kernel("later", 121, 122, 6),
        _kernel("unlaunched", 130, 131, 99),
        _kernel("hvd.forward", 12, 30, 7),               # an annotation
    ]
    events[-1].is_user_annotation = True
    p = spans.program_events(events)
    assert p["program_steps"] == 1
    assert p["program_launches"] == {"hvd.step": 4, "hvd.forward": 1,
                                     "hvd.backward": 1, "hvd.sync_grads": 1,
                                     "hvd.optimizer": 1}
    assert p["program_us"]["hvd.step"] == 18 + 8 + 6 + 3
    assert p["program_us"]["hvd.sync_grads"] == 6
    assert p["program_syncs"]["hvd.step"] == 1
    assert p["program_syncs"]["hvd.forward"] == 1
    assert p["sync_sites"] == {
        "hvd.forward > aten::item > aten::_local_scalar_dense "
        "> cudaStreamSynchronize": 1}
    assert p["collective_spans"] == ["hvd.sync_grads"]
    assert p["collective_us"] == {"hvd.sync_grads": 6}
    assert p["program_unbooked"] == 1
    # a program without step spans: nothing to book
    assert spans.program_events(events[5:])["program_steps"] == 0


def test_collectives_on_the_wall_clock():
    cpu = torch.autograd.DeviceType.CPU
    events = [_kernel("ncclDevKernel_AllReduce", 5.5, 7.0, 1),
              _kernel("gemm", 1.0, 2.0, 2),
              _kernel("ncclDevKernel_Broadcast", 3.0, 4.0, 3),
              _ev("hvd.step", 0, 9, cpu, annotation=True)]
    assert spans.collectives(events, 10 ** 9) == [
        [10 ** 9 + 3000, 10 ** 9 + 4000, "ncclDevKernel_Broadcast"],
        [10 ** 9 + 5500, 10 ** 9 + 7000, "ncclDevKernel_AllReduce"]]
    assert spans.collectives(events, None) is None


def _ranks(starts, ends, name="ncclDevKernel_AllReduce_Sum_f32_RING_LL"):
    """Four ranks' collective intervals (ns): kernel k of rank r runs
    from ``starts[k][r]`` to ``ends[k][r]``."""
    return [[[starts[k][r], ends[k][r], name] for k in range(len(starts))]
            for r in range(4)]


def test_cross_rank_wait_of_a_known_skew():
    # kernel 0: rank r starts r ms late; all end at 10 ms
    # kernel 1: every rank starts at 20 ms and ends at 25 ms
    ms = 10 ** 6
    per_rank = _ranks([[0, ms, 2 * ms, 3 * ms], [20 * ms] * 4],
                      [[10 * ms] * 4, [25 * ms] * 4])
    w = spans.cross_rank_waits(per_rank, ["hvd.forward", "hvd.sync_grads"])
    assert w["wait_us"] == [3000.0, 2000.0, 1000.0, 0.0]
    assert w["wait_us_by_span"] == {"hvd.forward": 1500.0,
                                    "hvd.sync_grads": 0.0}
    assert w["matched"] == 2 and w["aligned"]
    assert w["end_spread_us_median"] == 0.0
    # equal starts: nobody waits
    even = _ranks([[0] * 4, [20 * ms] * 4], [[10 * ms] * 4, [25 * ms] * 4])
    assert spans.cross_rank_waits(even)["wait_us"] == [0.0] * 4
    # a rank whose kernel ended before the last one started waited its all
    early = _ranks([[0, 0, 0, 8 * ms]], [[5 * ms, 9 * ms, 9 * ms, 9 * ms]])
    assert spans.cross_rank_waits(early)["wait_us"][0] == 5000.0


def test_cross_rank_wait_refuses_clocks_that_disagree():
    ms = 10 ** 6
    skewed = _ranks([[0, 0, 0, 5 * ms]] * 3, [[10 * ms, 10 * ms, 10 * ms,
                                               15 * ms]] * 3)
    w = spans.cross_rank_waits(skewed)
    assert w["end_spread_us_median"] == 5000.0 and not w["aligned"]
    assert spans.cross_rank_waits([skewed[0], skewed[1], skewed[2],
                                   skewed[3][:2]]) is None
    assert spans.cross_rank_waits([None] * 4) is None


def test_phases_of_recorded_steps():
    from horovod_tpu_torch.profiling import Span
    kept = [Span(0, "hvd.step", None, 1, 0, 10 ** 7),
             Span(1, "hvd.forward", 0, 1, 0, 4 * 10 ** 6),
             Span(2, "hvd.pack", 1, 1, 0, 10 ** 6),
             Span(3, "hvd.sync_grads", 0, 1, 5 * 10 ** 6, 6 * 10 ** 6),
             Span(4, "hvd.sync_grads", 0, 1, 7 * 10 ** 6, 8 * 10 ** 6),
             Span(5, "hvd.step", None, 1, 2 * 10 ** 7, 3 * 10 ** 7),
             Span(6, "hvd.forward", 5, 1, 2 * 10 ** 7, 21 * 10 ** 6),
             Span(7, "hvd.pack", None, 2, 0, 5)]
    assert spans.phase_ms(kept) == {"hvd.step": [10.0, 10.0],
                                     "hvd.forward": [4.0, 1.0],
                                     "hvd.sync_grads": [2.0, 0.0]}


TRACE = {"steps": 2, "program_steps": 4,
         "program_us": {"hvd.step": 800000.0, "hvd.sync_grads": 6000.0},
         "program_launches": {"hvd.step": 20000, "hvd.sync_grads": 90},
         "program_syncs": {"hvd.step": 2, "hvd.sync_grads": 0},
         "host_spans": {"hvd.step": [200.0, 210.0, 190.0],
                        "hvd.forward": [70.0, 90.0, 80.0],
                        "hvd.backward": [110.0, 100.0, 120.0],
                        "hvd.sync_grads": [5.0, 4.0, 6.0],
                        "hvd.optimizer": [9.0, 7.0, 8.0]}}


def test_readings_of_a_recorded_trace():
    assert spans.readings(TRACE) == pytest.approx({
        "host_forward_ms": 80.0, "host_backward_ms": 110.0,
        "host_sync_ms": 5.0, "host_optimizer_ms": 8.0,
        "sync_grads_ms": 1.5,            # 6 ms over 4 steps
        "launches_per_step": 5000.0, "host_syncs_per_step": 0.5})
    # a program without spans leaves nothing to read
    assert spans.readings({"steps": 2, "program_steps": 0,
                           "host_spans": {}}) == {}
    assert spans.readings(None) == {}


def test_report_gives_each_rank_its_wait():
    ms = 10 ** 6
    per_rank = _ranks([[0, ms, 2 * ms, 3 * ms]], [[10 * ms] * 4])
    recs = [{"rank": r, "trace": {**TRACE, "steps": 1, "collectives": c,
                                  "collective_spans": ["hvd.forward"]}}
            for r, c in reversed(list(enumerate(per_rank)))]
    out = spans.report(recs)
    # ranks waited 3, 2, 1 and 0 ms in the one traced step
    assert [x["collective_wait_ms"] for x in out["per_rank"]] == \
        pytest.approx([3.0, 2.0, 1.0, 0.0])
    assert out["metrics"]["collective_wait_ms"] == pytest.approx(1.5)
    assert out["metrics"]["launches_per_step"] == 5000.0
    assert out["collectives"]["wait_us_by_span"] == {"hvd.forward": 1500.0}
    one = spans.report(recs[-1:])
    assert "collective_wait_ms" not in one["metrics"]
    assert one["collectives"] is None


def test_spans_run_puts_its_capture_and_report_in_the_run():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import harness, run, spans, spans_run, trace\n"
            "assert trace.capture is spans.capture\n"
            "assert harness.summarize is spans_run._summarize_with_spans\n"
            "assert run.__file__.endswith('spans_run.py')\n" % str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=ROOT)
