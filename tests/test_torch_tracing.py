"""The port's spans and counters (``voicepuppet_torch/utils/tracing.py``)
on the CPU: what a span costs when nothing watches, what a recording
keeps from the serving threads, the frame counters against the tail
bucket, the profiler over every thread, and frames that do not depend on
any of it."""

import threading

import numpy as np
import pytest
import torch

from voicepuppet_torch.face3d import bfm as tbfm
from voicepuppet_torch.pipeline import streaming as tstream
from voicepuppet_torch.pipeline import synthesize as tsyn
from voicepuppet_torch.utils import tracing

from _torch_port_cases import port_cfg

torch.set_num_threads(1)

S = 256
CHUNK = 16
T = 21          # one full chunk and a 5-frame tail, rendered as 8


@pytest.fixture(scope="module")
def served():
    cfg = port_cfg()
    model = tbfm.synthetic_bfm(num_theta=16, num_phi=16, seed=1)
    bfm_state, g_state = tsyn.SynthesisAssets.init_trees(cfg, seed=0)
    synth = tsyn.Synthesizer(cfg, model, bfm_state, g_state, chunk=CHUNK,
                             raster_bb=24, gan_dtype=torch.float32,
                             drain_workers=1, device="cpu")
    ident = tsyn.synthetic_identity(model, seed=2, img_size=S)
    rng = np.random.RandomState(0)
    panel = rng.rand(S, 3 * S, 3).astype(np.float32)
    yield synth, ident, panel
    synth.close()


def _pcm(frames, seed=3):
    n = frames * 640
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.randn(n)).astype(np.float32)


def _synthesize(served):
    synth, ident, panel = served
    return synth.synthesize(panel, _pcm(T - 1), ident)


def _stream(served, blocks_of=2):
    synth, ident, panel = served
    ss = tstream.StreamingSynthesizer(synth, ident, panel[:, S:2 * S],
                                      panel[:, :S] * panel[:, 2 * S:])
    pcm = _pcm(CHUNK * blocks_of + 12)
    out = []
    for i in range(0, pcm.shape[0], 3200):
        out.extend(ss.feed(pcm[i:i + 3200]))
    return ss, out


def _named(summary, name):
    return [s for s in summary["spans"] if s["name"] == name]


def test_span_is_free_when_nothing_watches(monkeypatch):
    opened = []
    for mod, name in ((torch.profiler, "record_function"),
                      (torch._C._profiler, "_RecordFunctionFast")):
        monkeypatch.setattr(mod, name, lambda *a, **k: opened.append(a))
    first = tracing.span("vp.a", request=1, size=2)
    with first as got:
        assert got is None
        assert tracing.current() is None
    assert tracing.span("vp.b") is first      # one shared object
    tracing.count("vp.c", 3)
    assert opened == []


def test_recording_keeps_nesting_sizes_and_counts():
    with tracing.recording() as rec:
        with tracing.span("vp.outer", request=7) as outer:
            with tracing.span("vp.inner", size=3, device="cpu") as inner:
                assert tracing.current() is inner
            tracing.count("vp.n", 2)
            tracing.count("vp.n")
        assert tracing.current() is None
        held = tracing.span("vp.open_at_close").__enter__()
    out = rec.summary()
    held.__exit__(None, None, None)
    assert [s["name"] for s in out["spans"]] == ["vp.outer", "vp.inner"]
    o, i = out["spans"]
    assert i["parent"] == o["id"] == outer.index and o["parent"] is None
    assert i["request"] == 7 and i["size"] == 3 and i["device_ms"] is None
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= o["end_ns"]
    assert out["counts"] == {"vp.n": 3}
    assert out["start_ns"] <= o["start_ns"] and o["end_ns"] <= out["end_ns"]
    assert tracing.span("vp.after") is tracing.span("vp.other")


def test_one_recording_at_a_time():
    with tracing.recording():
        with pytest.raises(RuntimeError):
            tracing.recording().__enter__()


def test_drain_thread_spans_carry_the_call(served):
    with tracing.recording() as rec:
        _synthesize(served)
    out = rec.summary()
    (call,) = _named(out, "vp.synthesize")
    assert call["thread"] == threading.current_thread().name
    unpack = _named(out, "vp.drain.unpack")
    assert [s["size"] for s in unpack] == [CHUNK, T - CHUNK]
    for s in unpack:
        assert s["thread"].startswith("synth-drain")
        assert s["request"] == call["request"] and s["parent"] == call["id"]
    chunks = _named(out, "vp.render.chunk")
    assert [s["size"] for s in chunks] == [CHUNK, T - CHUNK]
    (coeff,) = _named(out, "vp.coeff")
    assert coeff["size"] == T and coeff["parent"] == call["id"]
    for s in chunks + _named(out, "vp.render.drain_wait"):
        assert s["request"] == call["request"]


def test_frame_counters_follow_the_tail_bucket(served):
    with tracing.recording() as rec:
        _synthesize(served)
    tail = T % CHUNK
    assert rec.summary()["counts"] == {
        "vp.frames.served": T,
        "vp.frames.padded": tsyn.tail_bucket(tail, CHUNK) - tail}


def test_profiler_holds_the_drain_thread_span(served):
    with tracing.profiler() as prof:
        _synthesize(served)
    threads = {}
    for e in prof.events():
        threads.setdefault(e.name, set()).add(e.thread)
        if e.name.startswith("vp."):
            # a host range like an op's, which no trace reads as device work
            assert not e.is_user_annotation, e.name
    assert len(threads["vp.synthesize"]) == 1
    assert threads["vp.drain.unpack"]
    assert threads["vp.drain.unpack"].isdisjoint(threads["vp.synthesize"])


@pytest.mark.parametrize("path", ["render_frames", "stream"])
def test_frames_do_not_depend_on_tracing(served, path):
    def frames():
        if path == "stream":
            return np.concatenate(_stream(served)[1])
        synth, ident, panel = served
        coeff = np.repeat(np.asarray(ident.bfmcoeff, np.float32), T, 0)
        coeff[:, 80:144] = np.random.RandomState(5).randn(T, 64) * 0.3
        return synth.render_frames(
            coeff, ident, panel[:, S:2 * S], panel[:, :S] * panel[:, 2 * S:],
            tsyn.constant_background(np.zeros((S, S, 3), np.float32)))

    off = frames()
    with tracing.recording():
        recorded = frames()
    with tracing.profiler():
        profiled = frames()
    np.testing.assert_array_equal(recorded, off)
    np.testing.assert_array_equal(profiled, off)


def test_stream_spans_carry_the_stream_id(served):
    with tracing.recording() as rec:
        first, blocks = _stream(served)
        second, _ = _stream(served, blocks_of=1)
    assert len(blocks) == 2 and first.coeffs.request != second.coeffs.request
    out = rec.summary()
    for name, per_first in (("vp.stream.coeff", 2), ("vp.stream.block", 2),
                            ("vp.drain.unpack", 2)):
        spans = _named(out, name)
        ids = [s["request"] for s in spans]
        assert ids.count(first.coeffs.request) == per_first, name
        assert ids.count(second.coeffs.request) == 1, name
        assert all(s["size"] == CHUNK for s in spans), name
