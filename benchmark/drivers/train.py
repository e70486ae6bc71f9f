"""PixRefer training: ``PixReferTrainer.train_step`` back to back for the
window, fed by the system's own input pipeline (JPEG decode and crops in
worker threads, ``prefetch_to_device``), or, where the workload's
``data`` names a ``cache``, by that many of the pipeline's first batches
held on the card and fed in turn, the pipeline closed before the first
step.  ``train_samples_per_s`` is the rows trained over the window's
time, the window closed by a synchronise.

Set-up builds one trainer and state and drives it through its first
steps with the window's own call and feed; the reference follows the
first three from the same weights and the same files: each step's
losses, the first gradient of every leaf (from Adam's first moment after
one step) and each leaf's change after three steps, each by its norm,
and the batches themselves."""

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

from benchmark import devicetime, flops, system, weights
from benchmark.harness import Outcome, Run
from benchmark.reference import data as ref_data
from benchmark.reference import nets
from benchmark.reference import train as ref_train
from benchmark.traffic import panels

G_STREAM, D_STREAM, VGG_STREAM = 3, 4, 5
CHECKED = 3


def make_weights(config: dict, seed: int, device):
    p = config["pixrefer"]
    return (weights.seeded_state(lambda: nets.PixReferNet(p["ngf"]),
                                 "pix2pix", seed, G_STREAM, device),
            weights.seeded_state(lambda: nets.Discriminator(p["ndf"]),
                                 "pix2pix", seed, D_STREAM, device),
            weights.seeded_state(
                lambda: nets.VGG16Features(tuple(config["vgg"]["widths"])),
                "lecun", seed, VGG_STREAM, device))


def _norms(tensors):
    return torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors]).cpu().tolist()


def run(run: Run) -> Outcome:
    config, wl = run.cell.config, run.cell.workload
    p = config["pixrefer"]
    dev = torch.device(run.device)
    cuda = dev.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="vpbench-train-")
    try:
        return _run(run, config, wl, p, dev, cuda, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(run, config, wl, p, dev, cuda, tmp):
    notes = []
    d = wl["data"]
    list_path = panels.write_panel_dataset(tmp, run.seed, d["clips"],
                                           d["frames"], p["img_size"])
    g_w, d_w, vgg_w = make_weights(config, run.seed, dev)
    trainer, state = system.pixrefer_trainer(config, g_w, d_w, vgg_w, dev)
    del g_w, d_w, vgg_w
    if any(system.tf32_flags()):
        raise SystemExit(f"the system left TF32 on {system.tf32_flags()}")
    seeds = [run.seed * d["workers"] + i for i in range(d["workers"])]
    tags = deque()
    pipeline, batches = system.pixrefer_batches(config, list_path, seeds,
                                                dev, tags)
    feed = batches
    if d.get("cache"):
        feed = itertools.cycle([next(batches) for _ in range(d["cache"])])
        pipeline.close()
    gen_p = list(state.gen.parameters())
    disc_p = list(state.disc.parameters())
    p0 = [t.detach().clone() for t in gen_p + disc_p]
    b1 = p["training"]["beta1"]
    fed, losses = [], []
    try:
        # ---- the checked first steps, through the window's call and feed
        for k in range(CHECKED + wl["warm_steps"]):
            batch = next(feed)
            if k < CHECKED:
                fed.append(tuple(t.cpu() for t in batch))
            state, m = trainer.train_step(state, batch)
            if k < CHECKED:
                losses.append((float(m["discrim_loss"]),
                               float(m["gen_loss"])))
            if k == 0:
                g1 = {name: _norms([o.state[t].get("mu", torch.zeros_like(
                    t)) / (1.0 - b1) for t in params])
                      for name, o, params in (
                          ("gen", state.g_optimizer, gen_p),
                          ("disc", state.d_optimizer, disc_p))}
            if k == CHECKED - 1:
                moved = _norms([t.detach() - t0 for t, t0 in
                                zip(gen_p + disc_p, p0)])
                del p0
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - run.t0
        notes.append(f"setup: {setup_s:.3f} s; first losses {losses}")

        # ---- the window -----------------------------------------------------
        waits, rows, marks, ends = [], [], [], []
        attempted = failed = 0
        start = time.perf_counter()
        while True:
            attempted += 1
            t0 = time.perf_counter()
            batch = next(feed)
            waits.append(time.perf_counter() - t0)
            mk = [] if run.trace and cuda else None
            try:
                state, m = trainer.train_step(state, batch, marks=mk)
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
        if rows:
            finite = torch.isfinite(torch.stack(rows)).all(1)
            failed += int((~finite).sum())
        rate = (attempted - failed) * p["batch_size"] / window_s
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        notes.append(f"window: {attempted} steps in {window_s:.3f} s; "
                     f"steps a 5 s {_per_span(ends, 5.0)}; data wait "
                     f"{1e3 * sum(waits) / len(waits):.2f} ms a step")

        layer, trace = {}, None
        if run.trace and cuda:
            layer = _layer(marks, attempted / window_s, p, config)
            trace = devicetime.traced(
                lambda: [trainer.train_step(state, next(feed))
                         for _ in range(3)])
            if trace is not None:
                layer["busy_s"] = trace["busy_s"]
                layer["window_s"] = trace["window_s"]
    finally:
        pipeline.close()
    del state, trainer, batches, feed, gen_p, disc_p
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


def _per_span(ends, span):
    """How many steps were launched in each ``span`` seconds of the
    window."""
    counts = [0] * (int(ends[-1] // span) + 1)
    for e in ends:
        counts[int(e // span)] += 1
    return counts


def _layer(marks, steps_per_s, p, config):
    d_ms = [a.elapsed_time(b) for a, b, _ in marks]
    g_ms = [b.elapsed_time(c) for _, b, c in marks]
    return {"d_step_ms": statistics.median(d_ms) if d_ms else None,
            "g_step_ms": statistics.median(g_ms) if g_ms else None,
            "step_flops": flops.train_step_flops(p["ngf"], p["ndf"],
                                                 p["batch_size"],
                                                 p["img_size"]),
            "steps_per_s": steps_per_s}


def reference_readings(config, list_path, seeds, tags, seed, dev,
                       control: bool = False):
    """The reference's three steps: (batches, losses, first gradient norms
    per model, change norms after three steps)."""
    p = config["pixrefer"]
    g_w, d_w, vgg_w = make_weights(config, seed, dev)
    nets.set_tf32(control)
    try:
        ref = ref_train.Trainer(config, g_w, d_w, vgg_w, dev)
        params = list(ref.gen.parameters()) + list(ref.disc.parameters())
        p0 = [t.detach().clone() for t in params]
        batches = [ref_data.batch(list_path, p["img_size"], p["crop_ratio"],
                                  seeds[w], j, p["batch_size"])
                   for w, j in tags]
        losses, grads = [], {}
        for k, b in enumerate(batches):
            losses.append(ref.step(b, grads if k == 0 else None))
        moved = _norms([t.detach() - t0 for t, t0 in zip(params, p0)])
    finally:
        nets.set_tf32(False)
    return batches, losses, grads, moved


def readings(losses, g1, moved, ref_losses, ref_grads, ref_moved) -> dict:
    """The numbers compared: the worst relative loss gap over the checked
    steps, the worst leaf's gap of first-gradient norms, and of change
    norms over the leaves the reference's gradient moves."""
    n_gen = len(ref_grads["gen"])
    keep = ref_train.moving(ref_grads["gen"]) + ref_train.moving(
        ref_grads["disc"])
    flat = lambda ls: [v for row in ls for v in row]  # noqa: E731
    return {
        "loss_gap": ref_train.loss_gap(flat(losses), flat(ref_losses)),
        "grad_gap": max(ref_train.norm_gap(g1["gen"], ref_grads["gen"]),
                        ref_train.norm_gap(g1["disc"], ref_grads["disc"])),
        "change_gap": max(
            ref_train.norm_gap(moved[:n_gen], ref_moved[:n_gen],
                               keep[:n_gen]),
            ref_train.norm_gap(moved[n_gen:], ref_moved[n_gen:],
                               keep[n_gen:]))}


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
