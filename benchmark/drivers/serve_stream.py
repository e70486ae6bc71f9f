"""Live sessions: ``sessions`` ``StreamingSynthesizer``s over one shared
``Synthesizer`` (chunk 16, the grouped raster K4), each fed 0.2 s of pcm
on a fixed real-time schedule from a start offset.  One thread serves the
feeds in order of their due times, as one live server would, open loop:
a feed is served at its due time or, when the server is behind, at once.
A block's latency runs from the due time of the feed that made it
computable to the return of its uint8 frames, so the wait behind other
sessions' feeds counts.  ``stream_block_p95_ms`` is the 95th percentile
over every block of the feeds due in the window; a feed that raises, or
whose blocks are missing, fails.

Checked: for two sessions drawn from the seed, one block each, drawn from
the seed among those due well inside the window, against the reference's
streaming pipeline, which replays the session's coefficient stream from
its start."""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from benchmark import devicetime, stats, system
from benchmark.drivers import _serve
from benchmark.harness import Outcome, Run
from benchmark.traffic import sessions
from benchmark.traffic.speech import speech


def session_audio(seed: int, k: int, samples: int, sr: int) -> np.ndarray:
    return speech(samples, np.random.default_rng([seed, 3, k]), sr)


def serve(streams, audio, schedule, feed, t_origin, lateness, blocks_out,
          keep, notes, tap=None):
    """Serve ``schedule`` [(due, session, feed index)] in order from
    ``t_origin``.  -> (latencies in s, feeds attempted, feeds failed)."""
    lat, failed = [], 0
    for due, s, j in schedule:
        now = time.perf_counter() - t_origin
        if now < due:
            time.sleep(due - now)
            now = time.perf_counter() - t_origin
        lateness.append((due, now - due))
        if tap is not None:
            tap.key = s
        try:
            out = streams[s].feed(audio[s][j * feed:(j + 1) * feed])
        except Exception:                                  # noqa: BLE001
            failed += 1
            notes.append(traceback.format_exc(limit=3))
            continue
        done = time.perf_counter() - t_origin
        for block in out:
            k = blocks_out[s]
            blocks_out[s] += 1
            lat.append(done - due)
            if (s, k) in keep:
                keep[(s, k)] = block
    return lat, len(schedule), failed


def audio_samples(seconds: float, wl: dict, sr: int) -> int:
    """pcm per session: the window, the offsets' spread and 2 s more."""
    return int((seconds + wl["spread_s"] + 2.0) * sr)


def checked_blocks(seed: int, k: int, seconds: float, wl: dict,
                   config: dict):
    """Two sessions drawn from the seed, one block each, after the first
    (so that the carried recurrence shows) and due well inside the
    window -> {(session, block)}."""
    rng = np.random.default_rng([seed, 41])
    frames_in = (seconds - wl["spread_s"]) * config["frame_rate"]
    per_session = int((frames_in - wl["ctx_right"]) / wl["chunk"]) - 1
    return {(int(s), int(rng.integers(1, max(2, per_session + 1))))
            for s in rng.choice(k, size=min(2, k), replace=False)}


def run(run: Run) -> Outcome:
    config, wl = run.cell.config, run.cell.workload
    dev = torch.device(run.device)
    cuda = dev.type == "cuda"
    chunk, group = wl["chunk"], wl["raster_group"]
    k = wl["sessions"]
    sr = config["mel"]["sample_rate"]
    feed = wl["feed_samples"]
    feed_s = feed / sr
    sc = _serve.make_scene(config, run.seed)
    synth = _serve.build(config, sc, run.seed, chunk, group, dev)
    sid = system.identity(sc.ident)
    bg = sc.background[None]
    audio = [session_audio(run.seed, s, audio_samples(run.seconds, wl, sr),
                           sr) for s in range(k)]

    def open_streams(n):
        return [system.streaming(synth, sid, sc.panel, bg, wl["ctx_left"],
                                 wl["ctx_right"]) for _ in range(n)]

    # warm-up: one session through its first blocks
    warm = open_streams(1)[0]
    warm_audio = session_audio(run.seed, k, 8 * feed * 4, sr)
    for j in range(8 * 4):
        warm.feed(warm_audio[j * feed:(j + 1) * feed])
    del warm
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t0
    notes = [f"setup: {setup_s:.3f} s; {k} sessions"]

    keep = {key: None for key in checked_blocks(run.seed, k, run.seconds,
                                                wl, config)}

    # ---- the window ---------------------------------------------------------
    streams = open_streams(k)
    tap = _serve.CoeffTap(synth)
    schedule = sessions.due_times(k, wl["spread_s"], feed_s, run.seconds,
                                  run.seed)
    lateness, blocks_out = [], [0] * k
    origin = time.perf_counter()
    lat, attempted, failed = serve(streams, audio, schedule, feed, origin,
                                   lateness, blocks_out, keep, notes, tap)
    tap.key = None
    tap.close()
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - origin
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    p95 = stats.percentile(lat, 95) * 1e3 if lat else float("inf")
    late = [x for _, x in lateness]
    q = max(1, len(late) // 4)
    notes.append(
        f"window: {len(lat)} blocks of {attempted} feeds in {window_s:.3f} s;"
        f" block latency p50 {stats.percentile(lat, 50) * 1e3:.1f} ms, p95 "
        f"{p95:.1f} ms; lateness mean first quarter "
        f"{np.mean(late[:q]) * 1e3:.1f} ms, last quarter "
        f"{np.mean(late[-q:]) * 1e3:.1f} ms, max {max(late) * 1e3:.1f} ms"
        if lat else "window: no block")

    layer = {"lateness_ms": [x * 1e3 for x in late]}
    trace = None
    if run.trace and cuda:
        layer |= _traced(synth, sid, sc, audio[0], chunk, config, wl, dev)
        rest = [(d - run.seconds, s, j) for d, s, j in sessions.due_times(
            k, wl["spread_s"], feed_s, run.seconds + 2.0, run.seed)
            if d >= run.seconds]
        trace = devicetime.traced(lambda: serve(
            streams, audio, rest, feed, time.perf_counter(), [],
            list(blocks_out), {}, []))
        if trace is not None:
            layer["busy_s"], layer["window_s"] = trace["busy_s"], trace[
                "window_s"]
    del streams
    _serve.release(synth)
    del synth

    # ---- the check ----------------------------------------------------------
    ref = _serve.reference(config, sc, run.seed, dev)
    served, want, served_c, want_c = {}, {}, {}, {}
    with ref:
        for (s, b), block in sorted(keep.items()):
            got, got_c = ref.stream_blocks(
                audio[s], sc.ident, sc.panel, sc.background, chunk,
                wl["ctx_left"], wl["ctx_right"], b + 1, {b})
            key = f"session {s} block {b}"
            want[key], want_c[key] = got[b], got_c[b]
            served[key] = (block if block is not None
                           else np.zeros_like(got[b]))
            mine = tap.kept.get(s, [])
            served_c[key] = (mine[b][0] if b < len(mine)
                             else torch.zeros_like(got_c[b]))
    checks = _serve.compare(served, want, wl["limits"]["frame_mad_max"],
                            notes)
    checks["coeff_gap"] = {"value": _serve.coeff_gap(served_c, want_c,
                                                     notes),
                           "limit": wl["limits"]["coeff_gap"]}
    if any(block is None for block in keep.values()):
        for v in checks.values():
            v["value"] = float("inf")
    return Outcome(attempted=attempted, failed=failed,
                   end_to_end={"stream_block_p95_ms": p95,
                               "setup_s": setup_s},
                   layer_data=layer, checks=checks,
                   memory_peak_bytes=memory_peak, trace=trace,
                   notes=notes + [f"blocks: {len(lat)}"])


@torch.inference_mode()
def _traced(synth, sid, sc, pcm, chunk, config, wl, dev):
    """A streaming coefficient predictor alone on one session's audio (host
    clock to a synchronise, per block), and one block's frame program, G
    and K4 by CUDA events."""
    from voicepuppet_torch.pipeline.streaming import StreamingCoeffPredictor
    pred = StreamingCoeffPredictor(synth, chunk=chunk,
                                   ctx_left=wl["ctx_left"],
                                   ctx_right=wl["ctx_right"])
    feed = wl["feed_samples"]
    per_block, exp = [], None
    for j in range(min(pcm.shape[0] // feed, 150)):
        t0 = time.perf_counter()
        got = pred.feed(pcm[j * feed:(j + 1) * feed])
        torch.cuda.synchronize()
        if got:
            per_block.append((time.perf_counter() - t0) * 1e3 / len(got))
            exp = got[0] if exp is None else exp
    layer = {"stream_coeff_ms": per_block}
    idc = torch.as_tensor(sc.ident["bfmcoeff"], device=dev)
    rows = torch.cat([idc[:, :80].expand(chunk, -1), exp,
                      idc[:, 144:].expand(chunk, -1)], -1).contiguous()
    layer.update(_serve.chunk_layer(synth, sid, sc, rows, config, dev))
    return layer
