"""PixFlow training: ``PixFlowTrainer.train_step`` back to back for the
window, as the PixRefer training cell runs its trainer (``train.py``):
the system's own input pipeline (``PixFlowBatcher`` in four decode
workers, ``prefetch_to_device``), whose first ``cache`` batches are held
on the card and fed in turn, the pipeline closed before the first step.
Each step draws its twelve dropout masks from one CUDA ``torch.Generator``
seeded from the run's seed.  ``train_samples_per_s`` is the rows trained
over the window's time, the window closed by a synchronise.  With
``--trace 1`` a span recording of the system is open over the window, and
on the card each step hands ``train_step`` a list for its CUDA events at
the start, after D and after G (``marks``), as ``train.py`` does.

Set-up first checks that the system's trainer records the spans the cell
reads (a small step, ``system_pixflow_train.check_spans``), then builds
one trainer and state and drives it through its first steps with the
window's own call, feed and dropout generator; the reference
(``reference/pixflow_train.py``) follows the first three from the same
weights, the same files and a dropout generator of the same seed: each
step's losses, the first gradient of every leaf (from Adam's first moment
after one step) and each leaf's change after three steps, each by its
norm, and the batches themselves (``reference/pixflow_data.py``)."""

from __future__ import annotations

import gc
import itertools
import shutil
import statistics
import tempfile
import time
import traceback
from collections import deque

import numpy as np
import torch

from benchmark import (devicetime, flops_pixflow_train, spans, system,
                       system_pixflow, system_pixflow_train, weights)
from benchmark.drivers.train import _norms, _per_span, readings
from benchmark.harness import Outcome, Run
from benchmark.reference import nets, pixflow_data, pixflow_train
from benchmark.traffic import panels

G_STREAM, D_STREAM, DROPOUT_STREAM = 6, 7, 8
CHECKED = 3


def make_weights(config: dict, seed: int, device):
    """(G's state, D's state) from the seed, on ``device``."""
    p = config["pixflow"]
    return (weights.seeded_state(
        lambda: pixflow_train.PixFlowTrainNet(p["ngf"]), "pix2pix", seed,
        G_STREAM, device),
        weights.seeded_state(lambda: nets.Discriminator(p["ndf"]),
                             "pix2pix", seed, D_STREAM, device))


def dropout_seed(seed: int) -> int:
    return (int(seed) * 1000003 + DROPOUT_STREAM) % (2 ** 63)


def dropout_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(dropout_seed(seed))
    return g


def run(run: Run) -> Outcome:
    dev = torch.device(run.device)
    system_pixflow_train.check_spans(dev)
    tmp = tempfile.mkdtemp(prefix="vpbench-train-pixflow-")
    try:
        return _run(run, run.cell.config, run.cell.workload, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(run, config, wl, dev, tmp):
    p = config["pixflow"]
    cuda = dev.type == "cuda"
    notes = []
    d = wl["data"]
    list_path = panels.write_panel_dataset(tmp, run.seed, d["clips"],
                                           d["frames"], p["img_size"])
    g_w, d_w = make_weights(config, run.seed, dev)
    trainer, state = system_pixflow_train.trainer(config, g_w, d_w, dev)
    del g_w, d_w
    if any(system.tf32_flags()):
        raise SystemExit(f"the system left TF32 on {system.tf32_flags()}")
    seeds = [run.seed * d["workers"] + i for i in range(d["workers"])]
    tags = deque()
    pipeline, batches = system_pixflow_train.batches(config, list_path,
                                                     seeds, dev, tags)
    feed = batches
    if d.get("cache"):
        feed = itertools.cycle([next(batches) for _ in range(d["cache"])])
        pipeline.close()
    gen = dropout_generator(run.seed, dev)
    rec = None
    try:
        # ---- the checked first steps, through the window's call and feed
        state, fed, losses, g1, moved = checked_steps(
            trainer, state, feed, gen, p["training"]["beta1"],
            wl["warm_steps"])
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - run.t0
        notes.append(f"setup: {setup_s:.3f} s; first losses {losses}")

        # ---- the window -----------------------------------------------------
        rec = system_pixflow.recording() if run.trace else None
        rows, ends, marks = [], [], []
        attempted = failed = 0
        if rec is not None:
            rec.__enter__()
        start = time.perf_counter()
        while True:
            attempted += 1
            mk = [] if run.trace and cuda else None
            try:
                state, m = trainer.train_step(state, next(feed),
                                              generator=gen, marks=mk)
                rows.append(torch.stack([m["discrim_loss"], m["gen_loss"]]))
                if mk is not None:
                    marks.append(mk)
            except Exception:                              # noqa: BLE001
                failed += 1
                notes.append(traceback.format_exc(limit=3))
            ends.append(time.perf_counter() - start)
            if ends[-1] >= run.seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - start
        if rec is not None:
            rec.__exit__(None, None, None)
        if rows:
            finite = torch.isfinite(torch.stack(rows)).all(1)
            failed += int((~finite).sum())
        rate = (attempted - failed) * p["batch_size"] / window_s
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        notes.append(f"window: {attempted} steps in {window_s:.3f} s; "
                     f"steps a 5 s {_per_span(ends, 5.0)}")

        layer, trace = {}, None
        if run.trace:
            layer = span_readings(rec.summary())
            layer.update(step_ms(marks))
            layer["step_flops"] = flops_pixflow_train.step_flops(
                p["ngf"], p["ndf"], p["batch_size"], p["img_size"])
            layer["steps_per_s"] = attempted / window_s
            trace = devicetime.traced(
                lambda: [trainer.train_step(state, next(feed),
                                            generator=gen)
                         for _ in range(3)])
            if trace is not None:
                layer["busy_s"] = trace["busy_s"]
                layer["window_s"] = trace["window_s"]
    finally:
        if rec is not None and rec.end_ns is None:
            rec.__exit__(None, None, None)
        pipeline.close()
    del state, trainer, batches, feed
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    values = _check(run, config, list_path, seeds, list(tags)[:CHECKED],
                    fed, losses, g1, moved, dev, notes)
    checks = {k: {"value": v, "limit": wl["limits"][k]}
              for k, v in values.items() if k in wl["limits"]}
    return Outcome(attempted=attempted, failed=failed,
                   end_to_end={"train_samples_per_s": rate,
                               "setup_s": setup_s},
                   layer_data=layer, checks=checks,
                   memory_peak_bytes=memory_peak, trace=trace, notes=notes,
                   readings=values)


def checked_steps(trainer, state, feed, generator, beta1: float,
                  warm_steps: int = 0):
    """The first ``CHECKED`` steps and ``warm_steps`` more on ``feed``
    with the window's call -> (state, the checked batches on the CPU,
    their (D, G) losses, the first gradient norms per model from Adam's
    first moment after one step, the change norms after ``CHECKED``)."""
    gen_p = list(state.gen.parameters())
    disc_p = list(state.disc.parameters())
    p0 = [t.detach().clone() for t in gen_p + disc_p]
    fed, losses = [], []
    for k in range(CHECKED + warm_steps):
        batch = next(feed)
        if k < CHECKED:
            fed.append(tuple(t.cpu() for t in batch))
        state, m = trainer.train_step(state, batch, generator=generator)
        if k < CHECKED:
            losses.append((float(m["discrim_loss"]), float(m["gen_loss"])))
        if k == 0:
            g1 = {name: _norms([o.state[t].get("mu", torch.zeros_like(t))
                                / (1.0 - beta1) for t in params])
                  for name, o, params in (
                      ("gen", state.g_optimizer, gen_p),
                      ("disc", state.d_optimizer, disc_p))}
        if k == CHECKED - 1:
            moved = _norms([t.detach() - t0 for t, t0 in
                            zip(gen_p + disc_p, p0)])
            del p0
    return state, fed, losses, g1, moved


def step_ms(marks) -> dict:
    """Median ms of the D half (start to after D) and the G half (after D
    to after G) over the steps' ``marks`` (None where there are none)."""
    d_ms = [a.elapsed_time(b) for a, b, _ in marks]
    g_ms = [b.elapsed_time(c) for _, b, c in marks]
    return {"d_step_ms": statistics.median(d_ms) if d_ms else None,
            "g_step_ms": statistics.median(g_ms) if g_ms else None}


def span_readings(summary: dict) -> dict:
    """The window's step spans, by ``benchmark/spans.py``'s arithmetic:
    median device ms a step of the D half, the G half and the no-grad G
    forward inside the D half (None where the system records none)."""
    halves = spans.train_readings(summary)
    return {"d_span_ms": halves["d_span_ms.train"],
            "g_span_ms": halves["g_span_ms.train"],
            "g_const_span_ms": spans._median(
                s["device_ms"] for s in spans._named(summary,
                                                     "vp.train.g_const"))}


def reference_readings(config, list_path, seeds, tags, seed, dev,
                       control: bool = False):
    """The reference's three steps: (batches, losses, first gradient norms
    per model, change norms after three steps)."""
    p = config["pixflow"]
    g_w, d_w = make_weights(config, seed, dev)
    nets.set_tf32(control)
    try:
        ref = pixflow_train.Trainer(config, g_w, d_w, dev,
                                    dropout_seed(seed))
        params = list(ref.gen.parameters()) + list(ref.disc.parameters())
        p0 = [t.detach().clone() for t in params]
        batches = [pixflow_data.batch(list_path, p["img_size"],
                                      p["crop_ratio"], seeds[w], j,
                                      p["batch_size"])
                   for w, j in tags]
        losses, grads = [], {}
        for k, b in enumerate(batches):
            losses.append(ref.step(b, grads if k == 0 else None))
        moved = _norms([t.detach() - t0 for t, t0 in zip(params, p0)])
    finally:
        nets.set_tf32(False)
    return batches, losses, grads, moved


def _check(run, config, list_path, seeds, tags, fed, losses, g1, moved, dev,
           notes):
    """Every number the reference's three steps give, compared or not."""
    batches, ref_losses, ref_grads, ref_moved = reference_readings(
        config, list_path, seeds, tags, run.seed, dev)
    batch_gap = max(float(np.abs(f.numpy() - w).max())
                    for fb, wb in zip(fed, batches) for f, w in zip(fb, wb))
    values = readings(losses, g1, moved, ref_losses, ref_grads, ref_moved)
    values["batch_gap"] = batch_gap
    notes.append(f"fed batches {tags}; losses {losses} reference "
                 f"{ref_losses}; readings {values}")
    return values
