"""Run one cell of the benchmark and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration file and
its workload file, ``benchmark/workloads/<name>.json``, whose ``driver``
names the module of ``benchmark/drivers/`` that runs it.  With
``--trace 0`` the line's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric>.py`` from what the driver measured.  Exits
nonzero with no result line where the card is missing, where a module
of JAX or of the JAX package is loaded, or where the run fails.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def run_cell(run: "harness.Run") -> "harness.Outcome":
    """Everything after the look for a card: the driver's run."""
    driver = importlib.import_module(
        f"benchmark.drivers.{run.cell.workload['driver']}")
    return driver.run(run)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.fix_cache_dirs()
    import torch
    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 3
    out = run_cell(harness.Run(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T0))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"benchmark: loaded modules of {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if args.trace:
        metrics = harness.read_per_layer(cell, out.layer_data)
    else:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out.end_to_end.items() if k in units}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    breakdown = None
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        breakdown = {"device_ops": out.trace["device_ops"],
                     "idle_gaps": out.trace["idle_gaps"]}
    for line in out.notes:
        print(line, file=sys.stderr)
    for line in harness.check_lines(out.checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(harness.judged(out.checks), out.attempted,
                              out.failed, metrics, device, breakdown,
                              out.checks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
