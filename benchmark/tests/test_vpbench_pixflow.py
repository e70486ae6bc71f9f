"""The PixFlow cell at test size on the CPU: a run is correct and, with
``--trace 1``, reports every per-layer metric of the cell; each fault
the cell can have comes out not correct at its limits; the reference's
FLOP split matches the count by hand.

Off the card the device timings are host-clock stand-ins: the carried
and held CUDA-event timings, the profiler's slice and a span's CUDA
events are replaced by the host's clock around the same calls, so the
test reads the driver's plumbing (every reader finds its data), not a
device number."""

import contextlib
import copy
import time

import pytest
import torch

from benchmark import devicetime, flops_pixflow, harness
from benchmark.run import run_cell
from benchmark.tests.test_vpbench_faults import altered_frame, patched

SEED = 2 ** 31 + 37
PIXFLOW_METRICS = ("frame_span_ms.pixflow", "gen_span_ms.pixflow",
                   "ref_span_ms.pixflow", "gen_roofline.pixflow",
                   "k1_roofline.pixflow", "serve_mfu.pixflow",
                   "idle_share.pixflow")


def tiny_pixflow_cell():
    """The PixFlow cell at CPU test size: ngf 8 at 128², a 24² face mesh,
    BFMNet at width 0.25, three short clips in chunks of 16."""
    cell = harness.load_cell("serve-pixflow-clips")
    cfg, wl = copy.deepcopy(cell.config), copy.deepcopy(cell.workload)
    cfg["pixflow"].update(ngf=8, img_size=128)
    cfg["raster"].update(size=128, bb=6)
    cfg["face_model"]["grid"] = 24
    cfg["bfmnet"]["backbone_width_mult"] = 0.25
    wl["clips"].update(count=3, min_frames=20, max_frames=60)
    wl["chunk"] = 16
    return harness.Cell(cell.name, cell.entry, wl, cfg, cell.end_to_end,
                        cell.per_layer)


def _run(seconds=0.5, trace=False):
    return run_cell(harness.Run(tiny_pixflow_cell(), SEED, seconds, trace,
                                "cpu", time.perf_counter()))


@contextlib.contextmanager
def host_clock_device_timings():
    """The driver's device timings, and the spans' device time, on the
    host's clock."""
    from voicepuppet_torch.utils import tracing

    def carried(step, first, k=8, repeats=3):
        t0 = time.perf_counter()
        step(first)
        return (time.perf_counter() - t0) * 1e3

    def held(fn, iters, warmup=2):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def traced(fn, top=10):
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
        return {"busy_s": wall / 2, "window_s": wall, "device_ops": [],
                "idle_gaps": []}

    record = tracing._Span.record

    def host_record(self):
        out = record(self)
        if out["device_ms"] is None:
            out["device_ms"] = (out["end_ns"] - out["start_ns"]) / 1e6
        return out

    with patched(devicetime, "carried_ms", carried), \
            patched(devicetime, "held_ms", held), \
            patched(devicetime, "traced", traced), \
            patched(tracing._Span, "record", host_record):
        yield


def test_a_run_is_correct_and_reports_every_metric():
    cell = tiny_pixflow_cell()
    assert {m["name"] for m in cell.per_layer} == set(PIXFLOW_METRICS)
    with host_clock_device_timings():
        out = _run(trace=True)
    assert harness.judged(out.checks), out.checks
    got = harness.read_per_layer(cell, out.layer_data)
    assert set(got) == set(PIXFLOW_METRICS), got
    # the shares are of a peak: positive, and the FLOPs per frame are the
    # reference's split at the cell's size
    assert all(v["value"] > 0 for v in got.values()), got
    data = out.layer_data
    assert data["gen_flops"] == flops_pixflow.per_frame_flops(8, 16, 128)


@contextlib.contextmanager
def post_resnet_skipped():
    """G's per-frame part leaves ``post_resnet`` out: the two streams'
    sum goes straight to the decoder."""
    import torch.nn.functional as F
    from voicepuppet_torch.models.pixflow import PixFlowGenerator

    def tail(self, h, diff_feat, res):
        h = h + res("diff_resnet_2", res("diff_resnet_1", diff_feat))
        for i in range(3):
            h = getattr(self, f"StatelessBatchNorm_{i}")(
                getattr(self, f"decoder_{i}")(F.relu(h)))
        h = self.final7(F.relu(h))
        return torch.tanh(h.float()).permute(0, 2, 3, 1)

    with patched(PixFlowGenerator, "_tail", tail):
        yield


@contextlib.contextmanager
def first_frame_as_reference():
    """The shared part's ``diffnet`` is fed a call's first frame's render
    in place of the panel's reference render."""
    from voicepuppet_torch.models.pixflow import PixFlowGenerator
    original = PixFlowGenerator.frame_forward
    first = {}

    def frame_forward(self, state, render_cur):
        h = state[0]
        if id(h) not in first:
            x = render_cur[:1].permute(0, 3, 1, 2).to(self.dtype)
            first[id(h)] = (h, self.diffnet(x))
        return original(self, first[id(h)], render_cur)

    with patched(PixFlowGenerator, "frame_forward", frame_forward):
        yield


@contextlib.contextmanager
def per_chunk_moments():
    """G's BN takes its moments over the whole chunk, as PixRefer's does,
    in place of each frame's own."""
    from voicepuppet_torch.models.pixflow import PixFlowNet
    with patched(PixFlowNet, "per_frame_moments", lambda self: self):
        yield


FAULTS = {"answer altered": altered_frame,
          "post_resnet skipped": post_resnet_skipped,
          "first frame as the reference": first_frame_as_reference}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    with FAULTS[fault]():
        out = _run()
    assert not harness.judged(out.checks), out.checks


def test_per_chunk_moments_reported():
    """Reported, not asserted: whether per-chunk moments pass the limit
    (the Tier-1 chunk-independence test guards the semantics)."""
    with per_chunk_moments():
        out = _run()
    v = out.checks["frame_mad_max"]
    print(f"per-chunk moments: frame_mad_max {v['value']:.4f} codes "
          f"(limit {v['limit']}), "
          f"{'fails' if v['value'] > v['limit'] else 'passes'}")
    assert v["value"] == v["value"]


def test_flop_split_matches_the_count_by_hand():
    """At ngf 64 and 512²: the shared part is the foreground encoder and
    ``diffnet`` (14.12 GFLOP each) and ``pre_resnet`` (two blocks of two
    3×3 convs at 32², 512 channels, 9.66 GFLOP a block); the per-frame
    part ``diffnet``, ``diff_resnet``, ``post_resnet`` and the decoder
    (three 4×4 deconvs and the 7×7 one, 46.24 GFLOP)."""
    def conv(h, k, ci, co):
        return 2 * h * h * k * k * ci * co

    enc = (conv(256, 7, 3, 64) + conv(128, 4, 64, 128)
           + conv(64, 4, 128, 256) + conv(32, 4, 256, 512))
    block = 2 * conv(32, 3, 512, 512)
    # a transposed conv's count is over its input's pixels
    dec = (conv(32, 4, 512, 512) + conv(64, 4, 512, 256)
           + conv(128, 4, 256, 128) + conv(256, 7, 128, 4))
    call, frame = enc + enc + 2 * block, enc + 4 * block + dec
    assert flops_pixflow.per_call_flops(64, 512) == call
    assert flops_pixflow.per_frame_flops(64, 32, 512) == 32 * frame
    assert flops_pixflow.generator_flops(64, 1, 512) == call + frame
    assert round(call / 1e9, 1) == 47.6 and round(frame / 1e9, 1) == 99.0
