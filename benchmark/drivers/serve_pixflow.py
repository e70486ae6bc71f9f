"""PixFlow batch clips: one client in a closed loop calls
``Synthesizer.synthesize(panel, pcm, identity)`` on a PixFlow Synthesizer
over the seed's clip cycle, repeated, for the window, as the PixRefer
batch cell does (``serve_batch.py``: the same clips, window, warm-up and
``batch_fps``).  With ``--trace 1`` a span recording of the system is
open over the window.

Checked: the first cycle's longest clip and one more drawn from the
seed, against the PixFlow reference (``reference/pixflow.py``: G on one
frame at a time, float32) once the window has closed and the system's
state is freed."""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from benchmark import (devicetime, flops, flops_pixflow, spans, stats,
                       system, system_pixflow, weights)
from benchmark.drivers import _serve, serve_batch
from benchmark.harness import Outcome, Run
from benchmark.reference import face, nets, pixflow
from benchmark.traffic import clips, scene


def make_scene(config: dict, seed: int) -> _serve.Scene:
    """The face model, identity and panel of the seed (no background:
    PixFlow composites on black)."""
    s = config["pixflow"]["img_size"]
    return _serve.Scene(scene.face_model_arrays(config["face_model"]["grid"],
                                                seed),
                        scene.identity(seed, s), scene.panel(seed, s), None)


def make_weights(config: dict, seed: int, device):
    """(BFMNet state, PixFlowNet state) from the seed, on ``device``."""
    bfm = weights.seeded_state(lambda: nets.BFMNet(config["bfmnet"]),
                               "glorot", seed, _serve.BFM_STREAM, device)
    gen = weights.seeded_state(
        lambda: pixflow.PixFlowNet(config["pixflow"]["ngf"]), "pix2pix",
        seed, _serve.G_STREAM, device)
    return bfm, gen


def reference(config: dict, sc: _serve.Scene, seed: int, device,
              mode: str = "reference") -> pixflow.Pipeline:
    bfm, gen = make_weights(config, seed, device)
    return pixflow.Pipeline(config, bfm, gen, sc.face_arrays, device, mode)


def build(config: dict, sc: _serve.Scene, seed: int, chunk: int,
          raster_group: int, device):
    """The system's PixFlow Synthesizer on the seed's weights; refuses
    TF32."""
    bfm, gen = make_weights(config, seed, device)
    synth = system_pixflow.synthesizer(config, sc.face_arrays, bfm, gen,
                                       chunk, raster_group, device)
    del bfm, gen
    if any(system.tf32_flags()):
        raise SystemExit(f"the system left TF32 on {system.tf32_flags()}: "
                         f"the float32 peak and the reference assume it off")
    return synth


def refs(sc: _serve.Scene):
    s = sc.panel.shape[0]
    return sc.panel[:, s:2 * s], sc.panel[:, :s] * sc.panel[:, 2 * s:]


def _warm(synth, sid, sc, pcms, frames, chunk, frame_samples):
    """Each coefficient bucket and each chunk size the cycle uses, once."""
    for b in sorted({face.coeff_bucket(t) for t in frames}):
        synth.predict_expressions(np.zeros(
            clips.samples_for_frames(b, frame_samples), np.float32))
    sizes = {chunk for t in frames if t >= chunk}
    sizes |= {face.tail_bucket(t % chunk, chunk) for t in frames
              if t % chunk}
    rows = np.repeat(np.asarray(sc.ident["bfmcoeff"], np.float32), chunk, 0)
    for size in sorted(sizes):
        synth.render_frames(rows[:size], sid, *refs(sc), None)
    synth.synthesize(sc.panel, pcms[int(np.argmin(frames))], sid)


def run(run: Run) -> Outcome:
    config, wl = run.cell.config, run.cell.workload
    dev = torch.device(run.device)
    cuda = dev.type == "cuda"
    chunk, group = wl["chunk"], wl["raster_group"]
    sr = config["mel"]["sample_rate"]
    fs = sr // config["frame_rate"]
    sc = make_scene(config, run.seed)
    frames = clips.cycle_frames(wl["clips"], run.seed)
    pcms = clips.cycle(wl["clips"], run.seed, sr, fs)
    synth = build(config, sc, run.seed, chunk, group, dev)
    sid = system.identity(sc.ident)

    def call(i):
        return synth.synthesize(sc.panel, pcms[i], sid)

    _warm(synth, sid, sc, pcms, frames, chunk, fs)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t0
    notes = [f"setup: {setup_s:.3f} s; cycle frames {frames}"]

    # ---- the window ---------------------------------------------------------
    rec = system_pixflow.recording() if run.trace else None
    tap = _serve.CoeffTap(synth)
    n = len(pcms)
    ends, done, kept = [], [], {}
    if rec is not None:
        rec.__enter__()
    start = time.perf_counter()
    i = 0
    while True:
        pos = i % n
        tap.key = pos if i < n else None
        try:
            out = call(pos)
            ok = out is not None and out.shape[0] == frames[pos]
        except Exception:                                  # noqa: BLE001
            ok, out = False, None
            notes.append(traceback.format_exc(limit=3))
        end = time.perf_counter()
        ends.append(end)
        done.append(frames[pos] if ok else 0)
        if ok and i < n:
            kept[pos] = out
        if end - start >= run.seconds:
            break
        i += 1
    if rec is not None:
        rec.__exit__(None, None, None)
    tap.key = None
    tap.close()
    calls, window_s = stats.closed_window(start, ends, run.seconds)
    fps = sum(done[:calls]) / window_s
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    per_call = [round(d / (b - a), 1)
                for d, a, b in zip(done, [start] + ends, ends)][:calls]
    notes.append(f"window: {calls} calls, {sum(done[:calls])} frames in "
                 f"{window_s:.3f} s; frames/s a call {per_call}")

    layer = {}
    trace = None
    if run.trace:
        layer, trace = _traced(synth, sc, pcms, frames, chunk, config, dev,
                               call, rec.summary())
        layer["fps_window"] = fps
    _serve.release(synth)
    del synth

    # ---- the check ----------------------------------------------------------
    sample = serve_batch.checked_clips(run.seed, frames, kept,
                                       wl["check"]["clips"])
    ref = reference(config, sc, run.seed, dev)
    name = lambda p: f"clip {p} ({frames[p]} frames)"  # noqa: E731
    with ref:
        want = {name(p): ref.clip_frames(pcms[p], sc.ident, sc.panel)
                for p in sample}
        want_c = {name(p): ref.coefficients(pcms[p]) for p in sample}
    served = {name(p): kept[p] for p in sample}
    served_c = {name(p): tap.kept[p][0][0, :frames[p]] for p in sample}
    checks = _serve.compare(served, want, wl["limits"]["frame_mad_max"],
                            notes)
    checks["coeff_gap"] = {"value": _serve.coeff_gap(served_c, want_c,
                                                     notes),
                           "limit": wl["limits"]["coeff_gap"]}
    if not sample:
        for v in checks.values():
            v["value"] = float("inf")
    return Outcome(attempted=calls, failed=sum(1 for d in done[:calls]
                                               if d == 0),
                   end_to_end={"batch_fps": fps, "setup_s": setup_s},
                   layer_data=layer, checks=checks,
                   memory_peak_bytes=memory_peak, trace=trace, notes=notes)


def span_readings(summary: dict, chunk: int, frame_rate: int) -> dict:
    """The window's spans, by ``benchmark/spans.py``'s arithmetic: median
    device ms of a full chunk's ``vp.render.chunk`` and ``vp.render.gen``
    and of a call's ``vp.render.ref``."""
    gen = [s["device_ms"] for s in spans._named(summary, "vp.render.gen")
           if s["size"] == chunk]
    return {"frame_span_ms": spans.batch_readings(summary, chunk, frame_rate)[
                "frame_span_ms.batch"],
            "gen_span_ms": spans._median(gen),
            "ref_span_ms": spans._median(
                s["device_ms"] for s in spans._named(summary,
                                                     "vp.render.ref"))}


@torch.inference_mode()
def _traced(synth, sc, pcms, frames, chunk, config, dev, call, summary):
    """The per-layer readings, after the window: the window's spans, G's
    per-frame part by CUDA events with a carried dependence and K1 alone
    behind a spin that holds the stream, both on the first chunk of the
    cycle's longest clip (its coefficient rows made as the system makes
    them, rendered by the reference); FLOP counts from the reference; a
    profiler trace of two calls."""
    layer = span_readings(summary, chunk, config["frame_rate"])
    s = synth.img_size
    fm = face.face_model_on(sc.face_arrays, dev)
    exp = synth.predict_expressions(pcms[int(np.argmax(frames))])
    idc = torch.as_tensor(sc.ident["bfmcoeff"], device=dev)
    rows = torch.cat([idc[:, :80].expand(chunk, -1), exp[0, :chunk],
                      idc[:, 144:].expand(chunk, -1)], -1).contiguous()
    imgs, verts, colors, winner = pixflow.canvas_renders(rows, fm, s)
    ref3d, fg = (torch.as_tensor(np.ascontiguousarray(r), device=dev)
                 for r in refs(sc))
    state = synth.pixflow_call_state(ref3d, fg)
    renders = nets.preprocess(imgs.float() / 255.0)
    gen = synth.gen.generator
    layer["gen_ms"] = devicetime.carried_ms(
        lambda x: x + 1e-30 * gen.frame_forward(state, x).reshape(-1)[0],
        renders)
    tri = fm.tri.to(torch.int32).contiguous()
    layer["raster_ms"] = devicetime.held_ms(
        lambda: system.render_colors(verts, colors, tri, s, s,
                                     synth.raster_group), 20)
    layer["raster_bound_ms"] = devicetime.raster_bound_ms(
        verts, colors, tri, winner, s, s)[0]
    ngf = config["pixflow"]["ngf"]
    layer["gen_flops"] = flops_pixflow.per_frame_flops(ngf, chunk, s)
    layer["gen_flops_per_frame"] = layer["gen_flops"] / chunk
    layer["call_flops_per_frame"] = (flops_pixflow.per_call_flops(ngf, s)
                                     * len(frames) / sum(frames))
    layer["bfm_flops_per_frame"] = sum(
        flops.bfmnet_flops(config["bfmnet"], t) for t in frames) / sum(frames)
    trace = devicetime.traced(lambda: [call(i) for i in (0, 1)])
    if trace is not None:
        layer["busy_s"], layer["window_s"] = trace["busy_s"], trace[
            "window_s"]
    return layer, trace
