"""Batch clips: one client in a closed loop calls
``Synthesizer.synthesize(panel, pcm, identity, backgrounds=...)`` over the
seed's clip cycle, repeated, for the window.  ``batch_fps`` is every frame
of every call in the window over the window's time; the window ends with
the first call that completes after ``--seconds``.

Checked: a sample of the first cycle's calls drawn from the seed, the
longest among them, against the reference pipeline once the window has
closed and the system's state is freed."""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from benchmark import devicetime, flops, stats, system
from benchmark.drivers import _serve
from benchmark.harness import Outcome, Run
from benchmark.reference import face
from benchmark.traffic import clips


def _warm(synth, sid, sc, pcms, frames, chunk, frame_samples, bg_iter):
    """Each coefficient bucket and each chunk size the cycle uses, once."""
    s = synth.img_size
    for b in sorted({face.coeff_bucket(t) for t in frames}):
        synth.predict_expressions(np.zeros(
            clips.samples_for_frames(b, frame_samples), np.float32))
    sizes = {chunk for t in frames if t >= chunk}
    sizes |= {face.tail_bucket(t % chunk, chunk) for t in frames
              if t % chunk}
    rows = np.repeat(np.asarray(sc.ident["bfmcoeff"], np.float32), chunk, 0)
    for size in sorted(sizes):
        synth.render_frames(rows[:size], sid, sc.panel[:, s:2 * s],
                            sc.panel[:, :s] * sc.panel[:, 2 * s:],
                            bg_iter())
    synth.synthesize(sc.panel, pcms[int(np.argmin(frames))], sid,
                     backgrounds=bg_iter())


def checked_clips(seed: int, frames, have, count: int):
    """The cycle positions checked: the longest of those served (``have``)
    and ``count - 1`` others drawn from the seed."""
    have = sorted(have, key=lambda p: -frames[p])
    rng = np.random.default_rng([seed, 40])
    return have[:1] + sorted(rng.choice(have[1:], size=min(
        count - 1, len(have) - 1), replace=False).tolist())


def run(run: Run) -> Outcome:
    config, wl = run.cell.config, run.cell.workload
    dev = torch.device(run.device)
    cuda = dev.type == "cuda"
    chunk, group = wl["chunk"], wl["raster_group"]
    sr = config["mel"]["sample_rate"]
    fs = sr // config["frame_rate"]
    sc = _serve.make_scene(config, run.seed)
    frames = clips.cycle_frames(wl["clips"], run.seed)
    pcms = clips.cycle(wl["clips"], run.seed, sr, fs)
    synth = _serve.build(config, sc, run.seed, chunk, group, dev)
    sid = system.identity(sc.ident)
    bg_iter = lambda: system.constant_background(sc.background)  # noqa: E731

    def call(i):
        return synth.synthesize(sc.panel, pcms[i], sid, backgrounds=bg_iter())

    _warm(synth, sid, sc, pcms, frames, chunk, fs, bg_iter)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t0
    notes = [f"setup: {setup_s:.3f} s; cycle frames {frames}"]

    # ---- the window ---------------------------------------------------------
    tap = _serve.CoeffTap(synth)
    n = len(pcms)
    ends, done, kept = [], [], {}
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
        layer, trace = _traced(synth, sid, sc, pcms, frames, chunk, config,
                               dev, call)
        layer["fps_window"] = fps
    _serve.release(synth)
    del synth

    # ---- the check ----------------------------------------------------------
    sample = checked_clips(run.seed, frames, kept, wl["check"]["clips"])
    ref = _serve.reference(config, sc, run.seed, dev)
    name = lambda p: f"clip {p} ({frames[p]} frames)"  # noqa: E731
    with ref:
        want = {name(p): ref.clip_frames(pcms[p], sc.ident, sc.panel,
                                         sc.background, chunk)
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


@torch.inference_mode()
def _traced(synth, sid, sc, pcms, frames, chunk, config, dev, call):
    """The per-layer readings, after the window: the drain's unpack of one
    packed chunk, the coefficient program per second of audio, the frame
    program, G and the raster kernel by CUDA events, FLOP counts from the
    reference, and a profiler trace of two calls."""
    layer = {}
    # the coefficient program over the cycle
    coeff_ms = []
    for pcm in pcms:
        t0 = time.perf_counter()
        synth.predict_expressions(pcm)
        torch.cuda.synchronize()
        coeff_ms.append((time.perf_counter() - t0) * 1e3)
    layer["coeff_ms"] = coeff_ms
    layer["audio_s"] = sum(p.shape[0] for p in pcms) / config["mel"][
        "sample_rate"]
    # one chunk of the longest clip, its inputs made as the system makes
    # them from the cell's clip
    longest = int(np.argmax(frames))
    exp = synth.predict_expressions(pcms[longest])
    idc = torch.as_tensor(sc.ident["bfmcoeff"], device=dev)
    rows = torch.cat([idc[:, :80].expand(chunk, -1), exp[0, :chunk],
                      idc[:, 144:].expand(chunk, -1)], -1).contiguous()
    ang = torch.as_tensor(face.head_sway(chunk)[0], device=dev)
    bg_pool, idx, ref3d, fg = _serve.chunk_inputs(sc, chunk, dev)
    prog = synth.frame_program_for(sid)
    packed = prog(rows, ang, bg_pool, idx, ref3d, fg).cpu().numpy()
    layer["unpack_ms"] = devicetime.host_ms(
        lambda: synth.fetch_frames(packed, chunk), 10)
    layer.update(_serve.chunk_layer(synth, sid, sc, rows, config, dev))
    # FLOPs a frame: G at the chunk's batch, BFMNet over each clip's frames
    layer["gen_flops_per_frame"] = flops.generator_flops(
        config["pixrefer"]["ngf"], chunk, synth.img_size) / chunk
    layer["bfm_flops_per_frame"] = sum(
        flops.bfmnet_flops(config["bfmnet"], t) for t in frames) / sum(frames)
    trace = devicetime.traced(lambda: [call(i) for i in (0, 1)])
    if trace is not None:
        layer["busy_s"], layer["window_s"] = trace["busy_s"], trace[
            "window_s"]
    return layer, trace
