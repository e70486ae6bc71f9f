"""End-to-end synthesis benchmark of the port on one card (counterpart of
the JAX package's root ``bench.py``, which stays the JAX package's).

The workload is the JAX bench's: ``Config()`` (PixRefer G ngf 64 at
512², BFMNet width 1.0), the 189² synthetic BFM (35,721 vertices, 70,688
triangles, the real BFM's scale), random weights from seed 0, chunk
``BENCH_CHUNK`` (32), the flat raster K1 (``BENCH_RASTER_GROUP`` 0), an
8 s 220 Hz sine at 0.3 amplitude, a ``RandomState(0)`` face panel and a
black background.  One warm-up call of ``Synthesizer.synthesize``, then
at least ``min_runs`` (4) timed calls and, within ``budget_s`` (360 s),
up to ``max_runs`` (60); a run's frames/s is its frame count over its
wall time (audio in, uint8 frames on the host out).

    python -m voicepuppet_torch.bench [--device cuda] [--config_path Y]
        [--seconds 8] [--budget_s 360] [--min_runs 4] [--max_runs 60]

prints one JSON line with the JAX bench's keys:

* ``value``: the best run's frames/s; ``fps_runs``: every run's (their
  median and spread tell a change from the machine's noise);
* ``vs_baseline``: ``value / cfg.frame_rate`` (25), the real-time factor.
  The JAX bench divides by a TPU's per-chip share of its target, which is
  no H100 figure;
* ``compute_fps``: ``chunk / Synthesizer.estimate_chunk_compute``, the
  frame program's device rate with no drain (None where the estimate
  comes out NaN);
* ``d2h_MBps``: a fresh 4 MB card buffer copied to the host, on runs 1,
  2 and every fifth (none on the CPU, where nothing crosses);
* ``raster_parity``: ``"ok"`` when ``ops.raster_selftest.run_selftest``
  passes after run 2 (on the CPU it holds the entry points' plain
  dispatch), else its ``AssertionError``, and the bench exits 1.  With
  ``BENCH_RASTER_PARITY=0`` or fewer than two runs it is ``"not run"``.

Any other fault (no card, a K1 build or launch) propagates and the bench
exits nonzero.  A watchdog emits the best run so far, marked
``"watchdog": true``, if the whole takes longer than
``WATCHDOG_SECONDS``.  :func:`measure` is the work without the watchdog
and the printing (``chip_smoke.py`` calls it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

WATCHDOG_SECONDS = 2400.0
D2H_PROBE_BYTES = 4 << 20
MESH_GRID = 189


def _fresh_record(frame_rate: int = 25) -> dict:
    return {"fps": None, "runs": 0, "compute_fps": None, "fps_runs": [],
            "d2h_MBps": [], "raster_parity": "not run",
            "frame_rate": frame_rate, "frames": None}


# what the watchdog emits: main's record, filled as the runs complete
_best = _fresh_record()


def _emit(fps: float, watchdog: bool = False):
    """The one JSON line, from ``fps`` and the record in ``_best``."""
    print(json.dumps({
        "metric": "e2e_synthesis_frames_per_sec_per_chip_512px",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / _best["frame_rate"], 4),
        "runs": _best["runs"],
        "watchdog": watchdog,
        "compute_fps": (round(_best["compute_fps"], 1)
                        if _best["compute_fps"] else None),
        "fps_runs": [round(v, 1) for v in _best["fps_runs"]],
        "d2h_MBps": [round(v, 1) for v in _best["d2h_MBps"]],
        "raster_parity": _best["raster_parity"],
    }), flush=True)


def _watchdog():
    time.sleep(WATCHDOG_SECONDS)
    if _best["fps"] is not None:
        _emit(_best["fps"], watchdog=True)
        os._exit(0)
    print("bench watchdog: no run completed", file=sys.stderr, flush=True)
    os._exit(1)


def _probe_d2h(device: torch.device, salt: float) -> float:
    """MB/s of one card-to-host copy of a fresh 4 MB buffer, made and
    finished on the card before the clock starts; one value read back."""
    n = D2H_PROBE_BYTES // 4
    buf = torch.arange(n, dtype=torch.float32, device=device) * salt
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    host = buf.cpu()
    dt = time.perf_counter() - t0
    if float(host[1]) != salt:
        raise AssertionError(f"d2h probe read {float(host[1])}, not {salt}")
    return (n * 4 / 1e6) / max(dt, 1e-9)


def workload(cfg, seconds: float):
    """(pcm, panel) of the JAX bench (``bench.py:116-122``)."""
    sr = cfg.mel.sample_rate
    pcm = (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(int(seconds * sr))
                        / sr)).astype(np.float32)
    s = cfg.pixrefer.img_size
    panel = np.random.RandomState(0).rand(s, 3 * s, 3).astype(np.float32)
    return pcm, panel


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def measure(cfg, face_model, *, device="cuda", seconds: float = 8.0,
            budget_s: float = 360.0, min_runs: int = 4, max_runs: int = 60,
            record: Optional[dict] = None) -> dict:
    """The benchmark's work (module docstring) on ``device``; returns
    ``record`` (a fresh dict by default), filled as the runs complete:
    ``fps`` (the best run), ``runs``, ``fps_runs``, ``compute_fps``,
    ``d2h_MBps``, ``raster_parity``, ``frame_rate`` and ``frames`` (the
    last run's)."""
    from voicepuppet_torch.ops.raster_selftest import run_selftest
    from voicepuppet_torch.pipeline.synthesize import (SynthesisAssets,
                                                       constant_background)
    record = {} if record is None else record
    record.clear()
    record.update(_fresh_record(cfg.frame_rate))
    dev = torch.device(device)
    chunk = _env_int("BENCH_CHUNK", 32)
    parity = os.environ.get("BENCH_RASTER_PARITY", "1") != "0"
    synth, identity = SynthesisAssets.demo(
        cfg, face_model=face_model, chunk=chunk,
        raster_group=_env_int("BENCH_RASTER_GROUP", 0), device=dev)
    pcm, panel = workload(cfg, seconds)
    s = cfg.pixrefer.img_size
    bg = np.zeros((s, s, 3), np.float32)

    def run():
        return synth.synthesize(panel, pcm, identity,
                                backgrounds=constant_background(bg))

    with synth:
        run()                                   # warm-up
        deadline = time.perf_counter() + budget_s
        runs = 0
        while runs < min_runs or (time.perf_counter() < deadline
                                  and runs < max_runs):
            t0 = time.perf_counter()
            frames = run()
            run_fps = frames.shape[0] / (time.perf_counter() - t0)
            runs += 1
            record["fps"] = max(record["fps"] or 0.0, run_fps)
            record["fps_runs"].append(run_fps)
            record["runs"] = runs
            record["frames"] = frames
            if dev.type == "cuda" and (runs <= 2 or runs % 5 == 0):
                record["d2h_MBps"].append(_probe_d2h(
                    dev, float(len(record["d2h_MBps"]) + 1)))
            if runs == 1:
                per_chunk = synth.estimate_chunk_compute(identity)
                if np.isfinite(per_chunk) and per_chunk > 0:
                    record["compute_fps"] = chunk / per_chunk
            if runs == 2 and parity:
                try:
                    run_selftest(dev)
                    record["raster_parity"] = "ok"
                except AssertionError as exc:
                    record["raster_parity"] = f"AssertionError: {exc}"
    return record


def main(argv=None) -> int:
    from voicepuppet_torch.config import load_config
    from voicepuppet_torch.face3d.bfm import synthetic_bfm
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--config_path", default=None,
                   help="a YAML profile over Config() (e.g. a small one "
                        "for a CPU run)")
    p.add_argument("--seconds", type=float, default=8.0,
                   help="seconds of audio per call")
    p.add_argument("--budget_s", type=float, default=360.0)
    p.add_argument("--min_runs", type=int, default=4)
    p.add_argument("--max_runs", type=int, default=60)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (pass --device cpu for a "
                         "CPU run)")
    threading.Thread(target=_watchdog, daemon=True).start()
    cfg = load_config(args.config_path)
    face_model = synthetic_bfm(num_theta=MESH_GRID, num_phi=MESH_GRID,
                               seed=0)
    measure(cfg, face_model, device=dev, seconds=args.seconds,
            budget_s=args.budget_s, min_runs=args.min_runs,
            max_runs=args.max_runs, record=_best)
    _emit(_best["fps"])
    return 0 if _best["raster_parity"] in ("ok", "not run") else 1


if __name__ == "__main__":
    sys.exit(main())
