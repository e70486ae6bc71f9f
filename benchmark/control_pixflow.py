"""The readings that the PixFlow cell's limits are set from, on the card,
in one process (``control.py``'s readings for the PixRefer cells): the
system's compared numbers over several seeds (each a short run of the
cell itself) and the lower-precision control's over three seeds or
more: the PixFlow reference one precision below the configuration's
(TF32 matmuls and convs, G's convs on fp8 operands computed in
bfloat16) against the float32 reference, on the clips a run of that
seed checks out of its whole first cycle.

    python -m benchmark.control_pixflow --seeds S [S ...]
        [--control-seeds S ...] [--fault-seeds S ...] [--seconds 4]
        [--out chiprun_out/control_pixflow.json]

The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmark import harness

WORKLOAD = "serve-pixflow-clips"


def serve_control(cell, seed) -> dict:
    from benchmark.drivers import _serve, serve_batch, serve_pixflow
    from benchmark.reference.serve import frame_mad
    from benchmark.traffic import clips
    config, wl = cell.config, cell.workload
    sr = config["mel"]["sample_rate"]
    sc = serve_pixflow.make_scene(config, seed)
    frames = clips.cycle_frames(wl["clips"], seed)
    pcms = clips.cycle(wl["clips"], seed, sr, sr // config["frame_rate"])
    items = serve_batch.checked_clips(seed, frames, range(len(frames)),
                                      wl["check"]["clips"])
    pipes = {m: serve_pixflow.reference(config, sc, seed, "cuda", m)
             for m in ("reference", "control")}
    worst, got_c, want_c = 0.0, {}, {}
    for p in items:
        got = {}
        for mode, pipe in pipes.items():
            with pipe:
                got[mode] = (pipe.clip_frames(pcms[p], sc.ident, sc.panel),
                             pipe.coefficients(pcms[p]))
        worst = max(worst, float(frame_mad(got["control"][0],
                                           got["reference"][0]).max()))
        got_c[p], want_c[p] = got["control"][1], got["reference"][1]
    return {"frame_mad_max": worst,
            "coeff_gap": _serve.coeff_gap(got_c, want_c, [])}


@contextlib.contextmanager
def per_chunk_moments():
    """The fault the cell's semantics rule out: G's BN takes its moments
    over the whole chunk, as PixRefer's does."""
    from voicepuppet_torch.models.pixflow import PixFlowNet
    original = PixFlowNet.per_frame_moments
    PixFlowNet.per_frame_moments = lambda self: self
    try:
        yield
    finally:
        PixFlowNet.per_frame_moments = original


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                   help="the system under per-chunk moments")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.fix_cache_dirs()
    import torch
    from benchmark.control import program_readings
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(WORKLOAD)
    lines = []
    for kind, seeds in (("system", args.seeds),
                        ("control", args.control_seeds),
                        ("per-chunk moments", args.fault_seeds)):
        for seed in seeds:
            if kind == "control":
                values = serve_control(cell, seed)
            else:
                with (per_chunk_moments() if kind != "system"
                      else contextlib.nullcontext()):
                    values = program_readings(cell, seed, args.seconds)
            line = {"workload": WORKLOAD, "kind": kind, "seed": seed,
                    "values": values,
                    "limits": cell.workload["limits"]}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
