"""The PixFlow training cell at test size on the CPU: a run is correct
and, with ``--trace 1``, reports every per-layer metric of the cell that
the CPU can read; each fault the training cell's limits must catch comes
out not correct; a system whose trainer records no spans is refused in
set-up; the readers' arithmetic; the step's FLOP count.  On the card (``-m card``): the TF32 control,
through the cell's comparison and limits, comes out not correct.

Off the card the device timings are host-clock stand-ins
(``test_vpbench_pixflow.host_clock_device_timings``), so the test reads
the driver's plumbing, not a device number."""

import copy
import time

import pytest

from benchmark import flops_pixflow, flops_pixflow_train, harness
from benchmark.control_pixflow_train import FAULTS, train_control
from benchmark.devicetime import H100_FP32_OPS_PER_S
from benchmark.drivers import train_pixflow
from benchmark.run import run_cell
from benchmark.tests.test_vpbench_pixflow import host_clock_device_timings

SEED = 2 ** 31 + 53
CELL = "train-pixflow512-b3"
METRICS = ("d_span_ms.pixflow_train", "g_span_ms.pixflow_train",
           "g_const_span_ms.pixflow_train", "d_step_ms.train",
           "g_step_ms.train", "train_mfu.train", "idle_share.train")
# read from the steps' CUDA events, which a run takes on the card alone
CARD_ONLY = {"d_step_ms.train", "g_step_ms.train"}
CONTROL_SEEDS = (2 ** 31 + 111, 2 ** 31 + 112, 2 ** 31 + 113)


def tiny_train_cell():
    """The PixFlow training cell at CPU test size: ngf and ndf 8 at 64²,
    2 clips of 4 frames, 8 held batches."""
    cell = harness.load_cell(CELL)
    cfg, wl = copy.deepcopy(cell.config), copy.deepcopy(cell.workload)
    cfg["pixflow"].update(ngf=8, ndf=8, img_size=64)
    wl["data"].update(clips=2, frames=4, cache=8)
    return harness.Cell(cell.name, cell.entry, wl, cfg, cell.end_to_end,
                        cell.per_layer)


def _run(seconds=0.5, trace=False, cell=None):
    return run_cell(harness.Run(cell or tiny_train_cell(), SEED, seconds,
                                trace, "cpu", time.perf_counter()))


def test_a_run_is_correct_and_reports_every_metric():
    cell = tiny_train_cell()
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert [m["name"] for m in cell.end_to_end] == ["train_samples_per_s",
                                                   "setup_s"]
    with host_clock_device_timings():
        out = _run(trace=True)
    assert out.failed == 0 and out.attempted > 0
    assert harness.judged(out.checks), out.checks
    assert out.readings["batch_gap"] == 0.0
    got = harness.read_per_layer(cell, out.layer_data)
    assert set(got) == set(METRICS) - CARD_ONLY, got
    assert all(v["value"] > 0 for v in got.values()), got
    # the no-grad forward lies inside the D half
    assert got["g_const_span_ms.pixflow_train"]["value"] < got[
        "d_span_ms.pixflow_train"]["value"]
    assert out.layer_data["step_flops"] == flops_pixflow_train.step_flops(
        8, 8, 3, 64)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    with FAULTS[fault]():
        out = _run()
    assert not harness.judged(out.checks), out.checks


def test_a_system_without_the_spans_is_refused_in_setup(monkeypatch):
    """As the parent commit is: its trainer opens no span, so the run
    stops in set-up with a reason, before the data is written."""
    from voicepuppet_torch.utils import tracing
    monkeypatch.setattr(tracing, "span", lambda *a, **k: tracing._OFF)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="does not record"):
        _run()
    assert time.perf_counter() - t0 < 60


def test_span_readings_take_medians_and_miss_nothing_silently():
    def span(name, i, ms, parent=None):
        return {"name": name, "id": i, "parent": parent, "device_ms": ms}
    summary = {"spans": [span("vp.train.d_half", 0, 30.0),
                         span("vp.train.g_const", 1, 12.0, 0),
                         span("vp.train.g_half", 2, 70.0),
                         span("vp.train.d_half", 3, 32.0),
                         span("vp.train.g_const", 4, 14.0, 3),
                         span("vp.train.g_half", 5, 68.0),
                         span("vp.train.d_half", 6, 31.0),
                         span("vp.train.g_const", 7, 13.0, 6),
                         span("vp.train.g_half", 8, 69.0)],
               "counts": {}}
    got = train_pixflow.span_readings(summary)
    assert got == {"d_span_ms": 31.0, "g_span_ms": 69.0,
                   "g_const_span_ms": 13.0}
    # a system that records no span: every reading is None, no reader
    # raises and none reports
    empty = train_pixflow.span_readings({"spans": [], "counts": {}})
    assert set(empty.values()) == {None}
    data = dict(empty, step_flops=None, steps_per_s=None)
    for name in METRICS:
        assert harness.reader(name)(data) is None


def test_mfu_and_idle_arithmetic():
    """The PixRefer training cell's readers, on this driver's data."""
    data = {"step_flops": 2.1e12, "steps_per_s": 10.0, "busy_s": 0.27,
            "window_s": 0.3}
    assert harness.reader("train_mfu.train")(data) == pytest.approx(
        100.0 * 2.1e13 / H100_FP32_OPS_PER_S)
    assert harness.reader("idle_share.train")(data) == pytest.approx(10.0)


def test_step_ms_takes_medians_of_the_marks():
    class Event:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    marks = [[Event(a), Event(b), Event(c)]
             for a, b, c in ((0, 35, 104), (200, 236, 305), (400, 434, 502))]
    got = train_pixflow.step_ms(marks)
    assert got == {"d_step_ms": 35, "g_step_ms": 69}
    assert harness.reader("d_step_ms.train")(got) == 35
    assert harness.reader("g_step_ms.train")(got) == 69
    assert train_pixflow.step_ms([]) == {"d_step_ms": None,
                                         "g_step_ms": None}


@pytest.mark.card
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_training_control_is_not_correct(card, seed):
    """The TF32 reference in the system's place, through the cell's own
    comparison and limits, is not correct."""
    harness.fix_cache_dirs()
    cell = harness.load_cell(CELL)
    values = train_control(cell, seed, card)
    checks = {k: {"value": v, "limit": cell.workload["limits"][k]}
              for k, v in values.items() if k in cell.workload["limits"]}
    assert not harness.judged(checks), checks


def test_step_flops_are_the_sum_of_their_parts():
    """At the cell's widths: G runs three times over (a no-grad forward,
    the loss forward, its backward at twice a forward less the input
    gradient of the three 7x7 stems, whose inputs need none); the step is
    G's part and D's within 1%."""
    parts = flops_pixflow_train.step_flops_by_part(64, 48, 3, 512)
    assert parts["step"] == pytest.approx(parts["gen"] + parts["disc"],
                                          rel=0.01)
    fwd = flops_pixflow.generator_flops(64, 3, 512)
    stem = 2 * 3 * 256 * 256 * 7 * 7 * 3 * 64
    assert parts["gen"] == 4 * fwd - 3 * stem
    assert round(parts["step"] / 1e12, 2) == 2.10
    assert 0.3e12 < parts["disc"] < 0.4e12
