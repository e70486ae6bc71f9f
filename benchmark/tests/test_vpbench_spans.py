"""``benchmark/spans.py``: the readings of a window's spans on synthetic
recordings, None where a span is missing; the split of device idle time
by host span on synthetic intervals, whose parts sum to the idle time;
and, at test size on the CPU, the window's recording hooked into the
serving and training drivers."""

import math

import pytest

from benchmark import spans

MS = 1_000_000      # ns


def _span(name, start_ms, end_ms, size=None, device_ms=None, thread="main",
          request=1):
    return {"name": name, "id": 0, "parent": None, "thread": thread,
            "request": request, "size": size, "start_ns": start_ms * MS,
            "end_ns": end_ms * MS, "device_ms": device_ms}


def _summary(span_list, counts=None, wall_ms=1000):
    return {"spans": span_list, "counts": counts or {}, "start_ns": 0,
            "end_ns": wall_ms * MS}


def test_batch_readings():
    got = spans.batch_readings(_summary([
        _span("vp.drain.unpack", 0, 180, size=32, thread="synth-drain_0"),
        _span("vp.drain.unpack", 200, 245, size=8, thread="synth-drain_0"),
        _span("vp.drain.fetch_wait", 10, 11), _span("vp.drain.fetch_wait",
                                                    20, 23),
        _span("vp.drain.fetch_wait", 30, 32),
        _span("vp.render.drain_wait", 300, 600),
        _span("vp.render.drain_wait", 700, 800),
        _span("vp.render.chunk", 0, 5, size=32, device_ms=31.0),
        _span("vp.render.chunk", 5, 9, size=32, device_ms=33.0),
        _span("vp.render.chunk", 9, 12, size=8, device_ms=9.0),
        _span("vp.coeff", 0, 3, size=50, device_ms=10.0),
        _span("vp.coeff", 3, 5, size=150, device_ms=50.0)],
        {"vp.frames.served": 97, "vp.frames.padded": 3}), 32, 25)
    assert got["drain_unpack_ms.batch"] == pytest.approx(225 / 40 * 32)
    assert got["drain_busy_share.batch"] == pytest.approx(22.5)
    assert got["drain_wait_share.batch"] == pytest.approx(40.0)
    assert got["fetch_wait_ms.batch"] == pytest.approx(2.0)
    assert got["frame_span_ms.batch"] == pytest.approx(32.0)
    assert got["coeff_span_ms_per_audio_s.batch"] == pytest.approx(60 / 8)
    assert got["pad_share.batch"] == pytest.approx(3.0)


def test_stream_and_train_readings():
    got = spans.stream_readings(_summary([
        _span("vp.drain.unpack", 0, 90, size=16),
        _span("vp.drain.unpack", 100, 180, size=16),
        _span("vp.drain.fetch_wait", 0, 20),
        _span("vp.stream.block", 0, 1, size=16, device_ms=18.0),
        _span("vp.stream.coeff", 0, 1, size=16, device_ms=9.0)]))
    assert got == {"drain_unpack_ms.stream": 85.0,
                   "fetch_wait_ms.stream": 20.0,
                   "frame_span_ms.stream": 18.0,
                   "coeff_span_ms.stream": 9.0}
    got = spans.train_readings(_summary([
        _span("vp.train.d_half", 0, 1, device_ms=39.0),
        _span("vp.train.d_half", 2, 3, device_ms=41.0),
        _span("vp.train.g_half", 1, 2, device_ms=50.0)]))
    assert got == {"d_span_ms.train": 40.0, "g_span_ms.train": 50.0}


@pytest.mark.parametrize("read", [
    lambda s: spans.batch_readings(s, 32, 25), spans.stream_readings,
    spans.train_readings])
def test_readings_are_none_without_their_spans(read):
    got = read({"spans": [], "counts": {}, "start_ns": None,
                "end_ns": None})
    assert got and all(v is None for v in got.values()), got
    # device readings of spans recorded off the card
    got = read(_summary([_span(n, 0, 1, size=32) for n in (
        "vp.render.chunk", "vp.coeff", "vp.stream.block", "vp.stream.coeff",
        "vp.train.d_half", "vp.train.g_half")]))
    for key in ("frame_span_ms.batch", "frame_span_ms.stream",
                "coeff_span_ms.stream", "d_span_ms.train", "g_span_ms.train"):
        assert got.get(key) is None


def test_idle_split_nested_spans_two_threads_and_none():
    # device busy [0, 10) and [40, 50) in a window [0, 100)
    device = [(0, 6), (4, 10), (40, 50)]
    host = [
        (5, 60, "vp.synthesize", 1),            # outer, main thread
        (12, 30, "vp.render.drain_wait", 1),    # inner, main waits ...
        (15, 35, "vp.drain.unpack", 2),         # ... while the drain works
        (55, 58, "vp.render.chunk", 1),
        (70, 80, "vp.drain.unpack", 2),
    ]
    got = spans.idle_by_span(device, host, 0, 100)
    assert got["window"] == 100 and got["busy"] == 20 and got["idle"] == 80
    under = got["under"]
    # [10, 12) synthesize; [12, 15) drain_wait; [15, 35) unpack over the
    # wait; [35, 40) synthesize; [50, 55) synthesize; [55, 58) chunk;
    # [58, 60) synthesize; [70, 80) unpack; [60, 70) + [80, 100) none
    assert under == pytest.approx({"vp.synthesize": 2 + 5 + 5 + 2,
                                   "vp.render.drain_wait": 3,
                                   "vp.drain.unpack": 20 + 10,
                                   "vp.render.chunk": 3})
    assert got["outside"] == pytest.approx(30)
    assert sum(under.values()) + got["outside"] == pytest.approx(got["idle"])
    shares = spans.slice_readings(got, "stream")
    assert shares["slice_idle_share.stream"] == pytest.approx(80.0)
    assert shares["idle_unpack_share.stream"] == pytest.approx(30.0)
    assert shares["idle_outside_spans.stream"] == pytest.approx(30.0)
    assert (sum(shares["idle_under"].values())
            + shares["idle_outside_spans.stream"]) == pytest.approx(
        shares["slice_idle_share.stream"])


def test_idle_split_of_a_busy_or_an_empty_window():
    got = spans.idle_by_span([(-5, 105)], [(0, 100, "vp.x", 1)], 0, 100)
    assert got["idle"] == 0 and got["under"] == {} and got["outside"] == 0
    got = spans.idle_by_span([], [], 0, 100)
    assert got["idle"] == 100 and got["outside"] == 100


@pytest.mark.parametrize("name, seconds", [("serve-batch-clips", 0.5),
                                           ("serve-stream-live", 3.5),
                                           ("train-pixrefer512-b2", 0.5)])
def test_window_recording_on_the_drivers(tiny, name, seconds):
    from benchmark.drivers import _serve
    tap = _serve.CoeffTap
    with spans.Probe(tiny(name)) as probe:
        line = probe.run(2 ** 31 + 35, seconds, False, True, device="cpu")
        off = probe.run(2 ** 31 + 35, seconds, False, False, device="cpu")
    assert _serve.CoeffTap is tap
    assert line["correct"] and off["correct"] and "window" not in off
    assert line["window_spans"] > 0 and line["window_s"] > 0
    host = {k: v for k, v in line["window"].items()
            if not k.startswith(("frame_span", "coeff_span", "d_span",
                                 "g_span", "fetch_wait"))}
    assert all(v is not None and math.isfinite(v) for v in host.values()), \
        line["window"]
