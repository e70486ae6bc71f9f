"""What the system's own spans and counters (``voicepuppet_torch/utils/
tracing.py``) say about a cell: the per-layer readings inside the timed
window, the device's idle time split by the span the host was in, and
what recording costs.  A tool run on the card, beside the benchmark;
``python -m benchmark.run`` reads none of it.

    python -m benchmark.spans --workload serve-batch-clips
        --seeds 2147483901 2147483902 --seconds 40 --trace 0 --record 0 1

For each seed, and for each ``--record`` value in turn, the cell's driver
runs as ``benchmark.run`` runs it (the same inputs, window and check;
``setup_s`` from the start of that run, so after the first run in a
process it leaves out the imports).  With record 1 a ``tracing.
recording()`` is open over the window: in the serving cells exactly from
the moment the driver attaches its coefficient tap, just before the
window's first call, to its detach just after the last; in training from
the run's start, keeping the spans that start after set-up, until the
traced slice (with ``--trace 0`` the window is the trainer's last use).
With ``--trace 1`` the driver's traced slice is followed by a second run
of the same work (batch: two calls; live: 2 s of the schedule; training:
three steps) under ``tracing.profiler()``, every thread, whose device
idle time is split by the innermost ``vp.`` span open in any thread
(:func:`idle_by_span`).  One JSON line a run."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import harness

SLICE = "benchmark.slice"


# ---- readings of the window's spans -----------------------------------------

def _named(summary: dict, name: str) -> List[dict]:
    return [s for s in summary["spans"] if s["name"] == name]


def _host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def _median(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def window_s(summary: dict) -> Optional[float]:
    if summary.get("start_ns") is None or summary.get("end_ns") is None:
        return None
    return (summary["end_ns"] - summary["start_ns"]) / 1e9


def batch_readings(summary: dict, chunk: int, frame_rate: int) -> dict:
    """The batch cell's readings from its window's spans and counts (None
    where the window holds none of the span)."""
    out: Dict[str, Optional[float]] = {}
    wall = window_s(summary)
    unpack = _named(summary, "vp.drain.unpack")
    frames = sum(s["size"] for s in unpack)
    out["drain_unpack_ms.batch"] = (sum(map(_host_ms, unpack)) / frames
                                    * chunk if frames else None)
    out["drain_busy_share.batch"] = (
        100.0 * sum(map(_host_ms, unpack)) / 1e3 / wall
        if unpack and wall else None)
    waits = _named(summary, "vp.render.drain_wait")
    out["drain_wait_share.batch"] = (
        100.0 * sum(map(_host_ms, waits)) / 1e3 / wall
        if waits and wall else None)
    out["fetch_wait_ms.batch"] = _median(
        map(_host_ms, _named(summary, "vp.drain.fetch_wait")))
    out["frame_span_ms.batch"] = _median(
        s["device_ms"] for s in _named(summary, "vp.render.chunk")
        if s["size"] == chunk)
    coeff = [s for s in _named(summary, "vp.coeff")
             if s["device_ms"] is not None]
    audio_s = sum(s["size"] for s in coeff) / frame_rate
    out["coeff_span_ms_per_audio_s.batch"] = (
        sum(s["device_ms"] for s in coeff) / audio_s if audio_s else None)
    counts = summary.get("counts", {})
    served = counts.get("vp.frames.served", 0)
    padded = counts.get("vp.frames.padded", 0)
    out["pad_share.batch"] = (100.0 * padded / (served + padded)
                              if served + padded else None)
    return out


def stream_readings(summary: dict) -> dict:
    """The live cell's readings: medians a block."""
    return {
        "drain_unpack_ms.stream": _median(
            map(_host_ms, _named(summary, "vp.drain.unpack"))),
        "fetch_wait_ms.stream": _median(
            map(_host_ms, _named(summary, "vp.drain.fetch_wait"))),
        "frame_span_ms.stream": _median(
            s["device_ms"] for s in _named(summary, "vp.stream.block")),
        "coeff_span_ms.stream": _median(
            s["device_ms"] for s in _named(summary, "vp.stream.coeff"))}


def train_readings(summary: dict) -> dict:
    """The training cell's step halves: median device ms."""
    return {f"{half}_span_ms.train": _median(
        s["device_ms"] for s in _named(summary, f"vp.train.{half}_half"))
        for half in ("d", "g")}


# ---- device idle time under the host's spans -------------------------------

def _union(intervals, t0, t1) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted((max(a, t0), min(b, t1)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _pick(open_spans) -> Optional[str]:
    """The span that holds the device back at an instant: per thread the
    innermost open span (the latest started); of those, one doing work
    over one waiting (a ``*_wait`` span), the latest started first."""
    inner = {}
    for a, b, name, thread in open_spans:
        if thread not in inner or a > inner[thread][0]:
            inner[thread] = (a, name)
    if not inner:
        return None
    best = max(inner.values(), key=lambda v: (not v[1].endswith("_wait"),
                                              v[0]))
    return best[1]


def idle_by_span(device: Sequence[Tuple[float, float]],
                 spans: Sequence[Tuple[float, float, str, object]],
                 t0: float, t1: float) -> dict:
    """Split the device's idle time in [t0, t1] by the host span open at
    each instant (:func:`_pick`).  ``device``: (start, end) of each device
    operation; ``spans``: (start, end, name, thread) of the host's spans,
    all on one clock.  -> {"window", "busy", "idle", "under": {name:
    idle}, "outside": idle under no span}; the parts of ``idle`` sum to
    it."""
    busy = _union(device, t0, t1)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if t1 > prev:
        gaps.append((prev, t1))
    spans = sorted(spans)
    under: Dict[Optional[str], float] = {}
    for g0, g1 in gaps:
        live = [s for s in spans if s[0] < g1 and s[1] > g0]
        cuts = sorted({g0, g1} | {x for s in live for x in s[:2]
                                  if g0 < x < g1})
        for p, q in zip(cuts, cuts[1:]):
            mid = (p + q) / 2
            name = _pick([s for s in live if s[0] <= mid < s[1]])
            under[name] = under.get(name, 0.0) + (q - p)
    outside = under.pop(None, 0.0)
    return {"window": t1 - t0, "busy": sum(b - a for a, b in busy),
            "idle": sum(b - a for a, b in gaps), "under": under,
            "outside": outside}


def slice_readings(split: dict, family: str) -> dict:
    """Shares of the slice's wall time, in %."""
    w = split["window"]
    out = {f"slice_idle_share.{family}":
           100.0 * split["idle"] / w,
           f"idle_outside_spans.{family}": 100.0 * split["outside"] / w,
           f"idle_unpack_share.{family}":
           100.0 * split["under"].get("vp.drain.unpack", 0.0) / w}
    out["idle_under"] = {k: 100.0 * v / w for k, v in sorted(
        split["under"].items(), key=lambda kv: -kv[1])}
    return out


def span_slice(fn) -> dict:
    """Run ``fn`` under ``tracing.profiler()`` and split its device idle
    time by span (times in microseconds of the profiler's clock).  The
    device's operations leave out the copies of user-scope ranges (the
    optimizers' ``record_function``) that the profiler draws on the
    device's timeline: they span the gaps between kernels."""
    import torch
    from voicepuppet_torch.utils import tracing
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with tracing.profiler() as prof:
        with torch._C._profiler._RecordFunctionFast(SLICE):
            fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    ranges = {e.name for e in events
              if e.device_type != cuda and e.is_user_annotation}
    device, spans, window = [], [], None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not e.is_user_annotation and e.name not in ranges:
                device.append((a, b))
        elif e.name == SLICE:
            window = (a, b)
        elif e.name.startswith("vp."):
            spans.append((a, b, e.name, e.thread))
    return idle_by_span(device, spans, *window)


# ---- the runs --------------------------------------------------------------

class Probe:
    """Hooks into one cell's driver, while entered: the window's
    recording and the second traced slice."""

    def __init__(self, cell: harness.Cell):
        self.cell = cell
        self.record = False
        self.window: Optional[object] = None
        self.slice: Optional[dict] = None
        self._saved = None

    def __enter__(self):
        from benchmark import devicetime
        from benchmark.drivers import _serve
        from voicepuppet_torch.utils import tracing
        probe = self
        tap, traced = _serve.CoeffTap, devicetime.traced

        class WindowTap(tap):
            def __init__(self, synth):
                super().__init__(synth)
                if probe.record:
                    probe.window = tracing.recording().__enter__()

            def close(self):
                probe.close_window()
                super().close()

        def traced_then_split(fn, top=10):
            probe.close_window()
            out = traced(fn, top)
            probe.slice = span_slice(fn)
            return out

        self._saved = (tap, traced)
        _serve.CoeffTap, devicetime.traced = WindowTap, traced_then_split
        return self

    def __exit__(self, *exc):
        from benchmark import devicetime
        from benchmark.drivers import _serve
        _serve.CoeffTap, devicetime.traced = self._saved
        return False

    def close_window(self):
        rec = self.window
        if rec is not None and rec.end_ns is None:
            rec.__exit__(None, None, None)

    def run(self, seed: int, seconds: float, trace: bool, record: bool,
            device: str = "cuda") -> dict:
        import torch
        from voicepuppet_torch.utils import tracing
        from benchmark.run import run_cell
        self.record, self.window, self.slice = record, None, None
        driver = self.cell.workload["driver"]
        t0 = time.perf_counter()
        if record and driver == "train":
            self.window = tracing.recording().__enter__()
        try:
            out = run_cell(harness.Run(self.cell, seed, seconds, trace,
                                       device, t0))
        finally:
            self.close_window()
        line = {"workload": self.cell.name, "seed": seed,
                "record": int(record), "trace": int(trace),
                "correct": harness.judged(out.checks),
                "end_to_end": out.end_to_end,
                "card": (torch.cuda.get_device_name(0)
                         if device == "cuda" else device)}
        if record:
            summary = self.window.summary()
            if driver == "train":
                since = int((t0 + out.end_to_end["setup_s"]) * 1e9)
                kept = [s for s in summary["spans"] if s["start_ns"] >= since]
                summary = dict(summary, spans=kept, start_ns=since,
                               end_ns=max((s["end_ns"] for s in kept),
                                          default=None))
            line["window_spans"] = len(summary["spans"])
            line["window_s"] = window_s(summary)
            line["window"] = self.readings(summary)
        if trace:
            line["per_layer"] = {k: v["value"] for k, v in
                                 harness.read_per_layer(
                                     self.cell, out.layer_data).items()}
            if out.trace is not None:
                line["idle_gaps"] = out.trace["idle_gaps"]
            if self.slice is not None:
                line["slice"] = slice_readings(self.slice, self.family)
        return line

    @property
    def family(self) -> str:
        return {"serve_batch": "batch", "serve_stream": "stream",
                "train": "train"}[self.cell.workload["driver"]]

    def readings(self, summary: dict) -> dict:
        if self.family == "batch":
            return batch_readings(summary, self.cell.workload["chunk"],
                                  self.cell.config["frame_rate"])
        if self.family == "stream":
            return stream_readings(summary)
        return train_readings(summary)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record", type=int, choices=(0, 1), nargs="+",
                   default=[1])
    args = p.parse_args(argv)
    harness.fix_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 3
    with Probe(harness.load_cell(args.workload)) as probe:
        for seed in args.seeds:
            for record in args.record:
                print(json.dumps(probe.run(seed, args.seconds,
                                           bool(args.trace), bool(record))),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
