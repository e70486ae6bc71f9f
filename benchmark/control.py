"""The readings that a cell's limits are set from, on the card, in one
process: the system's compared numbers over a dozen seeds or more (each
a short run of the cell itself), the lower-precision control's over
three seeds or more, and, for a training cell, the system with a fault
planted underneath.

    python -m benchmark.control --workload <name> --seeds S [S ...]
        [--control-seeds S ...] [--fault-seeds S ...] [--seconds 4]
        [--out chiprun_out/control.json]

The control is the reference put in the system's place one precision
below the configuration's: for serving, TF32 matmuls and convs and G's
convs on fp8 operands (the configuration serves G in bfloat16 and the
rest in float32); for training, TF32 (the configuration trains in
float32 with TF32 off).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from benchmark import harness


@contextlib.contextmanager
def half_batch():
    """The fault "half of the batch left out, the mean taken over the
    rest": every training step sees only the first half of its rows."""
    from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer
    original = PixReferTrainer.train_step

    def step(self, state, batch, marks=None):
        half = tuple(b[:max(1, b.shape[0] // 2)] for b in batch)
        return original(self, state, half, marks)

    PixReferTrainer.train_step = step
    try:
        yield
    finally:
        PixReferTrainer.train_step = original


def program_readings(cell, seed, seconds):
    from benchmark.run import run_cell
    out = run_cell(harness.Run(cell, seed, seconds, False, "cuda",
                               time.perf_counter()))
    return dict(out.readings)


def serve_control(cell, seed, seconds: float = 30.0):
    """The control's numbers on what a run of this seed checks: the
    batch cell's sampled clips (its whole first cycle served), the live
    cell's sampled blocks (of a window of ``seconds``)."""
    from benchmark.drivers import _serve, serve_batch, serve_stream
    from benchmark.reference.serve import frame_mad
    from benchmark.traffic import clips
    config, wl = cell.config, cell.workload
    sr = config["mel"]["sample_rate"]
    sc = _serve.make_scene(config, seed)
    pipes = {m: _serve.reference(config, sc, seed, "cuda", m)
             for m in ("reference", "control")}
    if wl["driver"] == "serve_batch":
        frames = clips.cycle_frames(wl["clips"], seed)
        pcms = clips.cycle(wl["clips"], seed, sr, sr // config["frame_rate"])
        items = serve_batch.checked_clips(seed, frames, range(len(frames)),
                                          wl["check"]["clips"])

        def item(pipe, p):
            return (pipe.clip_frames(pcms[p], sc.ident, sc.panel,
                                     sc.background, wl["chunk"]),
                    pipe.coefficients(pcms[p]))
    else:
        items = sorted(serve_stream.checked_blocks(
            seed, wl["sessions"], seconds, wl, config))
        n = serve_stream.audio_samples(seconds, wl, sr)

        def item(pipe, key):
            s, b = key
            got, coeffs = pipe.stream_blocks(
                serve_stream.session_audio(seed, s, n, sr), sc.ident,
                sc.panel, sc.background, wl["chunk"], wl["ctx_left"],
                wl["ctx_right"], b + 1, {b})
            return got[b], coeffs[b]
    worst, served_c, want_c = 0.0, {}, {}
    for key in items:
        got = {}
        for mode, pipe in pipes.items():
            with pipe:
                got[mode] = item(pipe, key)
        worst = max(worst, float(frame_mad(got["control"][0],
                                           got["reference"][0]).max()))
        served_c[key], want_c[key] = got["control"][1], got["reference"][1]
    return {"frame_mad_max": worst,
            "coeff_gap": _serve.coeff_gap(served_c, want_c, [])}


def train_control(cell, seed):
    """The TF32 reference against the float32 one on a worker's first
    three batches of this seed's files."""
    import shutil
    import tempfile
    from benchmark.drivers import train
    from benchmark.traffic import panels
    config, wl = cell.config, cell.workload
    d = wl["data"]
    tmp = tempfile.mkdtemp(prefix="vpbench-control-")
    try:
        lst = panels.write_panel_dataset(tmp, seed, d["clips"], d["frames"],
                                         config["pixrefer"]["img_size"])
        seeds = [seed * d["workers"] + i for i in range(d["workers"])]
        tags = [(0, 0), (0, 1), (0, 2)]
        _, ref_l, ref_g, ref_m = train.reference_readings(
            config, lst, seeds, tags, seed, "cuda")
        _, ctl_l, ctl_g, ctl_m = train.reference_readings(
            config, lst, seeds, tags, seed, "cuda", control=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return train.readings(ctl_l, ctl_g, ctl_m, ref_l, ref_g, ref_m)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.fix_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    rows = []

    def record(kind, seed, fn):
        t0 = time.perf_counter()
        try:
            values = fn()
        except Exception as exc:                           # noqa: BLE001
            values = {"error": repr(exc)}
        row = {"kind": kind, "seed": seed, "values": values,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for s in args.seeds:
        record("program", s, lambda: program_readings(cell, s, args.seconds))
    for s in args.control_seeds:
        record("control", s, lambda: (
            train_control(cell, s) if cell.workload["driver"] == "train"
            else serve_control(cell, s, args.seconds)))
    for s in args.fault_seeds:
        def faulty():
            with half_batch():
                return program_readings(cell, s, args.seconds)
        record("fault half_batch", s, faulty)
    summary = {"workload": args.workload,
               "card": torch.cuda.get_device_name(0), "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
