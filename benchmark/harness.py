"""What every cell shares: the checkout's cache directories, the cell's
files found by name, the per-layer readers, the guard against JAX, and
the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "voicepuppet_tpu")


def fix_cache_dirs(root: Path = ROOT):
    """Every build and kernel cache at a fixed path inside the checkout
    (the raster library builds into ``build/`` by itself), so that only a
    checkout's first run builds.  Set before torch is imported."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    workload: dict       # benchmark/workloads/<name>.json
    config: dict         # benchmark/configs/<config>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(root / cfg_entry["file"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, entry, workload, config, e2e, layer)


def reader(metric: str):
    """The per-layer metric's reader, ``benchmark/metrics/<name>.py``:
    ``read(data) -> float or None``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, data: Dict[str, Any]) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(data)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that no run may hold."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


def judged(checks: Dict[str, dict]) -> bool:
    """Every compared number finite and at or under its limit."""
    return all(isinstance(v["value"], (int, float))
               and math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in checks.values())


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict], checks: Dict[str, dict]) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


@dataclasses.dataclass
class Run:
    """One run of a cell: what the driver is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                 # the process's start, perf_counter


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the counts, the end-to-end values, the
    per-layer readers' data, the compared numbers with their limits, the
    peak memory, the traced slice, and lines for standard error."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    layer_data: Dict[str, Any]
    checks: Dict[str, dict]
    memory_peak_bytes: int
    trace: Optional[dict] = None
    notes: List[str] = dataclasses.field(default_factory=list)
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for k, v in self.checks.items():
            self.readings.setdefault(k, v["value"])
