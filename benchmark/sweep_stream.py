"""The knee of a live-sessions cell: the largest number of sessions at
which the serving loop's lateness does not grow over a window.  Run once
on the card when the cell is defined; the cell's file stores 4/5 of the
knee, rounded down, at least 1.

    python -m benchmark.sweep_stream --workload serve-stream-live
        --sessions 2 4 6 8 --seconds 20 --seed 7

For each count it prints the blocks, the block latency's median and 95th
percentile, and the loop's mean lateness over the first and the last
quarter of the feeds.  A count holds where the last quarter's lateness is
within a tenth of a feed period (``feed_samples`` of audio, 20 ms at
0.2 s) of the first's: past the knee the backlog grows all through the
window.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

from benchmark import harness


def sweep_row(cell, sessions: int, seed: int, seconds: float) -> dict:
    from benchmark.drivers import serve_stream
    wl = dict(cell.workload, sessions=sessions)
    one = dataclasses.replace(cell, workload=wl)
    out = serve_stream.run(harness.Run(one, seed, seconds, False, "cuda",
                                       time.perf_counter()))
    late = out.layer_data["lateness_ms"]
    q = max(1, len(late) // 4)
    first, last = statistics.fmean(late[:q]), statistics.fmean(late[-q:])
    period_ms = 1e3 * wl["feed_samples"] / cell.config["mel"]["sample_rate"]
    return {"sessions": sessions,
            "p95_ms": out.end_to_end["stream_block_p95_ms"],
            "lateness_first_ms": first, "lateness_last_ms": last,
            "holds": last - first < 0.1 * period_ms,
            "notes": [n for n in out.notes if n.startswith("window")]}


def knee_sessions(rows) -> int:
    """4/5 of the largest count that holds (below the first that does
    not), rounded down, at least 1."""
    knee = 0
    for row in sorted(rows, key=lambda r: r["sessions"]):
        if not row["holds"]:
            break
        knee = row["sessions"]
    return max(1, int(knee * 4 // 5))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="serve-stream-live")
    p.add_argument("--sessions", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    harness.fix_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    rows = []
    for k in args.sessions:
        rows.append(sweep_row(cell, k, args.seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"sessions_4_5_of_knee": knee_sessions(rows),
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
