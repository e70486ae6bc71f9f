"""The readings that the PixFlow training cell's limits are set from, on
the card, in one process: the system's compared numbers over a set of
seeds (each a short run of the cell itself), the lower-precision
control's, and the system with a fault planted underneath.

    python -m benchmark.control_pixflow_train --seeds S [S ...]
        [--control-seeds S ...] [--fault-seeds S ...] [--seconds 4]
        [--out control_pixflow_train.json]

The control is the reference put in the system's place one precision
below the configuration's: TF32 matmuls and convs (the configuration
trains in float32 with TF32 off), against the float32 reference on the
same weights, batches and dropout seed.  The faults (:data:`FAULTS`):
half of each batch's rows left out, the mean taken over the rest; the
dropout masks drawn from another seed; ``diffnet``'s branch on the
reference render cut from the graph, so the shared weights lose their
second gradient path.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from benchmark import harness

CELL = "train-pixflow512-b3"


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def half_batch():
    """Every training step sees only the first half of its rows."""
    from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
    original = PixFlowTrainer.train_step

    def step(self, state, batch, generator=None, marks=None):
        half = tuple(b[:max(1, b.shape[0] // 2)] for b in batch)
        return original(self, state, half, generator, marks)

    with _patched(PixFlowTrainer, "train_step", step):
        yield


@contextlib.contextmanager
def other_dropout_seed():
    """The steps draw their dropout masks from a generator of another
    seed than the one they are given."""
    import torch
    from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
    original = PixFlowTrainer.train_step
    others = {}

    def step(self, state, batch, generator=None, marks=None):
        if generator is not None:
            if id(generator) not in others:
                other = torch.Generator(device=generator.device)
                other.manual_seed(generator.initial_seed() + 1)
                others[id(generator)] = (generator, other)
            generator = others[id(generator)][1]
        return original(self, state, batch, generator, marks)

    with _patched(PixFlowTrainer, "train_step", step):
        yield


@contextlib.contextmanager
def diffnet_ref_detached():
    """G's forward takes ``diffnet``'s features of the reference render
    as a constant: the difference's second gradient path into the shared
    weights is dropped."""
    from voicepuppet_torch.models.pixflow import PixFlowGenerator

    def forward(self, inputs, fg_inputs, train=False, generator=None):
        x = inputs.permute(0, 3, 1, 2).to(self.dtype)
        fg = fg_inputs.permute(0, 3, 1, 2).to(self.dtype)
        encode_feat = self.encoder_net(fg[:, :3])
        diff_feat = (self.diffnet(x[:, 3:])
                     - self.diffnet(x[:, :3]).detach())
        res = lambda name, v: getattr(self, name)(  # noqa: E731
            v, train, generator)
        h = res("pre_resnet_2", res("pre_resnet_1", encode_feat))
        return self._tail(h, diff_feat, res)

    with _patched(PixFlowGenerator, "forward", forward):
        yield


FAULTS = {"half_batch": half_batch, "other_dropout_seed": other_dropout_seed,
          "diffnet_ref_detached": diffnet_ref_detached}


def program_readings(cell, seed, seconds, device="cuda"):
    from benchmark.run import run_cell
    out = run_cell(harness.Run(cell, seed, seconds, False, device,
                               time.perf_counter()))
    return dict(out.readings)


def train_control(cell, seed, device="cuda"):
    """The TF32 reference against the float32 one on a worker's first
    three batches of this seed's files."""
    import shutil
    import tempfile
    from benchmark.drivers import train, train_pixflow
    from benchmark.traffic import panels
    config, wl = cell.config, cell.workload
    d = wl["data"]
    tmp = tempfile.mkdtemp(prefix="vpbench-control-pixflow-")
    try:
        lst = panels.write_panel_dataset(tmp, seed, d["clips"], d["frames"],
                                         config["pixflow"]["img_size"])
        seeds = [seed * d["workers"] + i for i in range(d["workers"])]
        tags = [(0, 0), (0, 1), (0, 2)]
        _, ref_l, ref_g, ref_m = train_pixflow.reference_readings(
            config, lst, seeds, tags, seed, device)
        _, ctl_l, ctl_g, ctl_m = train_pixflow.reference_readings(
            config, lst, seeds, tags, seed, device, control=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return train.readings(ctl_l, ctl_g, ctl_m, ref_l, ref_g, ref_m)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
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
    cell = harness.load_cell(CELL)
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
        record("control", s, lambda: train_control(cell, s))
    for s in args.fault_seeds:
        for name, fault in FAULTS.items():
            def faulty():
                with fault():
                    return program_readings(cell, s, args.seconds)
            record(f"fault {name}", s, faulty)
    summary = {"workload": CELL, "card": torch.cuda.get_device_name(0),
               "power_limit": _power_limit(), "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


def _power_limit():
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
