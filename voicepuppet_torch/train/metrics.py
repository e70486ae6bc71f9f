"""Training observability (port of ``voicepuppet_tpu/train/metrics.py``).

The reference prints per-step losses and writes TensorBoard scalar and
image summaries (train_bfmnet.py:124, train_pixrefer.py:101-131).  Here:
a JSONL metrics stream ``<name>_metrics.jsonl``, stdout mirroring, event
files (``utils/tb_writer.py``), image dumps, gradient histograms, and a
``torch.profiler`` trace hook (the reference has no profiler).
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np
import torch

from voicepuppet_torch.utils import tracing


def _number(v) -> float:
    if isinstance(v, torch.Tensor):
        return float(v.detach().float().cpu())
    return float(np.asarray(v))


class MetricsLogger:
    """JSONL metrics + stdout + TensorBoard events (``tensorboard``),
    images under ``<log_dir>/images`` and gradient histograms."""

    def __init__(self, log_dir: str, name: str = "train",
                 print_every: int = 1, tensorboard: bool = True,
                 histogram_interval: int = 100):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._f = open(self.path, "a")
        self.print_every = print_every
        # gradient histograms at the reference's summary cadence
        # (train_pixflow.py:131-134); 0 turns them off
        self.histogram_interval = histogram_interval
        self._t0 = time.time()
        self._tb = None
        if tensorboard:
            from voicepuppet_torch.utils.tb_writer import TBEventWriter
            self._tb = TBEventWriter(os.path.join(log_dir, "tb", name))

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            rec[k] = v if isinstance(v, str) else _number(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "wall_s") and not isinstance(v, str):
                    self._tb.scalar(k, v, int(step))
            self._tb.flush()
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(f"{k}={rec[k]:.6g}" for k in metrics
                             if not isinstance(metrics[k], str))
            print(f"step {step}: {parts}", flush=True)

    def log_image(self, step: int, name: str, image: np.ndarray):
        """``images/<name>_<step>.jpg`` and an image summary."""
        from PIL import Image
        from voicepuppet_torch.utils.tb_writer import _to_uint8
        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        arr = _to_uint8(image)
        Image.fromarray(arr).save(os.path.join(img_dir,
                                               f"{name}_{step}.jpg"))
        if self._tb is not None:
            self._tb.image(name, arr, int(step))
            self._tb.flush()

    def log_histograms(self, step: int,
                       groups: Mapping[str, Mapping[str, torch.Tensor]],
                       exclude: tuple = ()):
        """One histogram per gradient: ``groups`` maps a group name (e.g.
        "generator") to ``{parameter name: gradient}``; tags are
        ``<group>/<name>/gradients`` (train_pixflow.py:113-115), skipping
        tags containing any ``exclude`` substring.  The gradients reach
        the host in one copy."""
        if self._tb is None:
            return
        kept = [(f"{group}/{name}", g) for group, grads in groups.items()
                for name, g in grads.items()
                if g is not None
                and not any(e in f"{group}/{name}" for e in exclude)]
        if kept:
            flat = torch.cat([g.detach().float().reshape(-1)
                              for _, g in kept]).cpu().numpy()
            ends = np.cumsum([g.numel() for _, g in kept])
            for (tag, g), values in zip(kept, np.split(flat, ends[:-1])):
                self._tb.histogram(tag + "/gradients",
                                   values.reshape(g.shape), int(step))
        self._tb.flush()

    @property
    def wants_histograms(self) -> bool:
        """True when histograms would be written at all: the trainers ask
        before they gather gradients for the logger."""
        return self._tb is not None and bool(self.histogram_interval)

    def histogram_due(self, step: int) -> bool:
        """True at the steps that are multiples of ``histogram_interval``
        (when histograms are written at all): a caller gathers the
        gradients only then."""
        return (self.wants_histograms
                and int(step) % self.histogram_interval == 0)

    def maybe_log_histograms(self, step: int, groups, exclude: tuple = ()):
        """:meth:`log_histograms` at the steps :meth:`histogram_due`
        names; between them nothing is read from the device."""
        if self.histogram_due(step):
            self.log_histograms(int(step), groups, exclude)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class ProfilerHook:
    """A ``torch.profiler`` trace (CPU and, on the card, CUDA activity, in
    every thread: ``utils.tracing.profiler``, so the data workers and the
    trainers' ``vp.train.*`` spans are in it) of the steps
    [start, start + count), written as a Chrome trace
    ``<log_dir>/trace_<start>.json``.  ``step(step, k)`` is called before
    each dispatch with the global step and the number of global steps the
    dispatch covers, ``[step, step + k)``: the trace opens at the first
    dispatch that overlaps the window and closes at the first that starts
    at or past its end, so the window snaps outward to whole dispatches.
    (The JAX package's hook compares only the dispatch's first step and
    misses a window that lies inside one dispatch.)"""

    def __init__(self, log_dir: str, start_step: int = 0,
                 num_steps: int = 0):
        self.log_dir = log_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None
        self.path = None

    def step(self, step: int, k: int = 1):
        if self.stop <= self.start:
            return
        if step >= self.stop:
            self.close()
        elif step + k > self.start and self._prof is None \
                and self.path is None:
            self._prof = tracing.profiler()
            self._prof.__enter__()

    def close(self):
        """Stop and write the trace if one is running."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_{self.start}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None


def add_profiler_args(parser):
    """``--profile_steps`` / ``--profile_start`` for the trainer CLIs."""
    parser.add_argument(
        "--profile_steps", type=int, default=0,
        help="trace this many steps with torch.profiler into "
             "<log_dir>/profile (a Chrome trace); 0 disables")
    parser.add_argument(
        "--profile_start", type=int, default=2,
        help="global step at which the trace window opens (default 2: "
             "the first steps hold the warm-up)")


def profiler_from_args(args):
    """None when --profile_steps is 0, else a ProfilerHook under
    <log_dir>/profile."""
    if getattr(args, "profile_steps", 0) <= 0:
        return None
    return ProfilerHook(os.path.join(args.log_dir, "profile"),
                        args.profile_start, args.profile_steps)
