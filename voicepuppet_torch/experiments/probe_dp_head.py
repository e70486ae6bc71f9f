"""Where BFMNet's two-rank gradients part from the single-process step's
at full width on one card (``chip_smoke.py`` phase 22's configuration:
``Config()``'s BFMNet, B 8, T 24, the 189² synthetic BFM, dropout off,
cuDNN deterministic).

One forward per run (train mode; sync-BN over the group for the two
ranks), then one backward per loss form from that forward:

  * ``l1``: the trainer's loss (``BFMNetLoss`` + the L2 term);
  * ``l1 fixed signs``: the same loss with each vertex residual's sign
    taken from the plain single-process run, so a residual whose sign
    flips under float noise keeps the plain run's gradient;
  * ``smooth <k>``: ``sqrt(r² + eps²)`` in place of ``|r|``, eps = k times
    the plain run's median |r| over the valid frames.

Runs: the single-process step (``plain``, ``plain again``), its
float-order variants (``cudnn off``, ``half-batch kernels``, ``float64
moments``; :class:`half_batch_kernels`) and two gloo ranks sharing
the card (``2 ranks``).  Each is held against ``plain``:

  * the forward: the output's max |diff| over its max, the residuals'
    sign flips over the valid frames and the largest |r| that flipped,
    every batch norm's moments (the mean's shift in units of the
    channel's std, and the old reading, the shift over the largest
    |mean|, which reads large where the means are near zero);
  * the gradients of each loss form: the head (every leaf outside the
    MfccNet trunk) in relative L2 and its worst leaf over that leaf's max
    |g|; the trunk's worst leaf and relative L2, with the leaves whose
    true gradient is zero apart (the offsets of the inverted residuals'
    projection and shortcut batch norms, held by |diff|); and, for the
    two ranks, twice the average and a rank's own gradient (no average)
    as controls.

Run on the card from the repository root: ``python -m
voicepuppet_torch.experiments.probe_dp_head``.  It prints one line per
run, traced module and loss form.
"""

from __future__ import annotations

import os
import re
import sys
import tempfile
import time

import torch

EPS_SCALES = (1e-3, 1e-2)
BN_EPS = 1e-3
TRUNK = "mfcc_encoder.MfccNet_0."
# the offsets of an inverted residual's projection and shortcut batch
# norms: no activation follows them, and every path from them runs through
# 1x1 convs, max pools and sums into a later train-mode batch norm, which
# removes a per-channel constant, so their true gradient is zero
TRUE_ZERO = re.compile(r"\.InvertedResidual_\d+\.TFBatchNorm_[23]\.bias$")
RUNS = ("plain again", "cudnn off", "half-batch kernels", "float64 moments")
# the modules whose outputs, and the l1 loss's gradients there, are traced
TRACE = ("mfcc_encoder", "rnn_in", "rnn_module", "bfm_coeff_decoder.Dense_0",
         "bfm_coeff_decoder.Dense_1", "bfm_coeff_decoder.Dense_2")


def _smoke():
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    return chip_smoke


class half_batch_kernels:
    """Within the block (when ``on``), ``F.conv2d``, ``F.conv_transpose2d``
    and ``F.linear`` run each half of their batch as a call of its own and
    concatenate: the same rows through the kernels a rank of a two-rank
    group launches (half the batch each)."""

    NAMES = ("conv2d", "conv_transpose2d", "linear")

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        import torch.nn.functional as F
        if not self.on:
            return
        self.saved = {n: getattr(F, n) for n in self.NAMES}

        def split(fn):
            def run(x, *a, **k):
                if x.dim() < 2 or x.shape[0] % 2:
                    return fn(x, *a, **k)
                h = x.shape[0] // 2
                return torch.cat([fn(x[:h], *a, **k), fn(x[h:], *a, **k)])
            return run
        for n, fn in self.saved.items():
            setattr(F, n, split(fn))

    def __exit__(self, *exc):
        import torch.nn.functional as F
        if self.on:
            for n, fn in self.saved.items():
                setattr(F, n, fn)


def moments64(xf, group=None):
    red = (0,) + tuple(range(2, xf.dim()))
    var, mean = torch.var_mean(xf.double(), dim=red, correction=0)
    return mean.float(), var.float()


def residuals(loss_fn, out, coeff):
    """The vertex residuals of the frame term [B, T, 3N] and of the
    temporal term [B, T-1, 3N] (``BFMNetLoss.__call__``)."""
    b, t, _ = out.shape
    w = loss_fn.weighted_ex_base
    delta = out - coeff[:, :, 80:144]
    frame = (delta.reshape(b * t, -1) @ w.T).reshape(b, t, -1)
    vid = ((delta[:, 1:] - delta[:, :-1]).reshape(b * (t - 1), -1)
           @ w.T).reshape(b, t - 1, -1)
    return frame, vid


def loss_of(loss_fn, out, coeff, seq_len, absf):
    """``BFMNetLoss`` with ``absf(residual, term)`` in place of |.|."""
    b, t, _ = out.shape
    frame, vid = residuals(loss_fn, out, coeff)
    steps = torch.arange(t, device=out.device)
    mask = (steps[None, :] < seq_len[:, None]).float()
    vid_mask = (steps[None, :-1] < (seq_len - 1)[:, None]).float()
    return (torch.mean(torch.sum(absf(frame, 0).sum(-1) * mask, -1))
            + torch.mean(torch.sum(absf(vid, 1).sum(-1) * vid_mask, -1)))


def run_step(mesh, variant, eps, signs):
    """One forward of phase 22's BFMNet on this process's rows, then a
    backward of each loss form; the recorded moments, output, residuals
    and (averaged, and for ``l1`` also local) gradients."""
    c = _smoke()
    from voicepuppet_torch.models import layers
    from voicepuppet_torch.models.bfmnet import l2_regularization
    from voicepuppet_torch.parallel.mesh import (all_reduce_grads_,
                                                 group_of, rank_rows)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.enabled = variant != "cudnn off"
    dev = mesh.device if mesh is not None else torch.device("cuda:0")
    tr, state, _ = c.dp_trainer("bfmnet", dev, mesh,
                                lambda p: torch.optim.SGD(p, lr=1.0),
                                dropout=False)
    model = state.model
    batch = c.dp_batch("bfmnet")
    lo = 0
    if mesh is not None:
        lo = mesh.rank * (len(batch[0]) // mesh.world)
        batch = rank_rows(batch, mesh)
    coeff, ears, mfccs, seq_len = (torch.as_tensor(b).to(dev)
                                   for b in batch)
    rec = []
    real = layers.batch_moments
    base = moments64 if variant == "float64 moments" else real

    def recording(xf, group=None):
        m, v = base(xf, group)
        rec.append((m.detach().cpu(), v.detach().cpu()))
        return m, v
    layers.batch_moments = recording
    acts, cots = {}, {}

    def keep(name, o):
        acts[name] = o.detach().cpu()
        def first(g):   # the first backward's (l1) cotangent
            if name not in cots:
                cots[name] = g.detach().cpu()
        if o.requires_grad:
            o.register_hook(first)

    hooks = [model.get_submodule(n).register_forward_hook(
        lambda mod, i, o, n=n: keep(n, o[0] if isinstance(o, tuple) else o))
        for n in TRACE]
    try:
        with half_batch_kernels(variant == "half-batch kernels"), \
                layers.sync_bn(group_of(mesh), model):
            out = model(ears, mfccs, seq_len, train=True)
    finally:
        layers.batch_moments = real
        for h in hooks:
            h.remove()
    keep("output", out)
    frame, vid = residuals(tr.loss_fn, out.detach(), coeff)
    rows = slice(lo, lo + len(coeff))
    forms = {"l1": lambda r, k: torch.abs(r)}
    if signs is not None:
        s = [x[rows].to(dev) for x in signs]
        forms["l1 fixed signs"] = lambda r, k: s[k] * r
    for scale in EPS_SCALES:
        e = scale * eps
        forms[f"smooth {scale:g}"] = (
            lambda r, k, e=e: torch.sqrt(r * r + e * e))
    params = list(model.named_parameters())
    grads, local = {}, None
    for i, (form, absf) in enumerate(forms.items()):
        model.zero_grad(set_to_none=True)
        loss = (loss_of(tr.loss_fn, out, coeff, seq_len, absf)
                + l2_regularization(model, 1e-4))
        loss.backward(retain_graph=i + 1 < len(forms))
        if form == "l1":
            local = {n: p.grad.detach().cpu().clone() for n, p in params}
        all_reduce_grads_([p for _, p in params], group_of(mesh))
        grads[form] = {n: p.grad.detach().cpu().clone() for n, p in params}
    torch.backends.cudnn.enabled = True
    return {"moments": rec, "out": out.detach().cpu(),
            "frame": frame.cpu(), "vid": vid.cpu(), "seq_len": seq_len.cpu(),
            "grads": grads, "local": local, "acts": acts, "cots": cots}


def rank_main(mesh, eps, signs_path, work):
    signs = torch.load(signs_path, weights_only=True)
    got = run_step(mesh, "2 ranks", eps, signs)
    path = os.path.join(work, f"rank{mesh.rank}.pt")
    torch.save(got, path)
    return path


def valid(seq_len, t, k):
    steps = torch.arange(t)
    return steps[None, :] < (seq_len - k)[:, None]


def forward_stats(run, ref):
    out = float((run["out"] - ref["out"]).abs().max()
                / ref["out"].abs().max())
    flips, flip_max, noise = 0, 0.0, 0.0
    for k, term in enumerate(("frame", "vid")):
        m = valid(ref["seq_len"], ref[term].shape[1], k)
        a, b = ref[term][m], run[term][m]
        f = torch.sign(a) != torch.sign(b)
        flips += int(f.sum())
        if f.any():
            flip_max = max(flip_max, float(a[f].abs().max()))
        noise = max(noise, float((a - b).abs().max()))
    bns = []
    for i, ((m0, v0), (m1, v1)) in enumerate(zip(ref["moments"],
                                                 run["moments"])):
        std = torch.sqrt(v0 + BN_EPS)
        bns.append((i, float(((m1 - m0).abs() / std).max()),
                    float((m0.abs() / std).max()),
                    float((m1 - m0).abs().max()
                          / (m0.abs().max() + 1e-12)),
                    float(((v1 - v0).abs() / v0.abs().max()).max())))
    return {"out_rel": out, "sign_flips": flips,
            "largest_flipped_abs_r": flip_max, "residual_max_diff": noise,
            "bn": bns}


def trace_stats(run, ref):
    """Per traced module: its output's and its l1 cotangent's max |diff|
    over their max, the cotangent's by batch row, and the outputs whose
    sign differs from ``ref``'s (a leaky ReLU follows ``rnn_in`` and the
    decoder's Dense_0 and Dense_1) with the largest |value| among them."""
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    out = {}
    for k in ref["cots"]:
        a, b = run["acts"][k], ref["acts"][k]
        flip = (a > 0) != (b > 0)
        out[k] = (rel(a, b), rel(run["cots"][k], ref["cots"][k]),
                  [rel(x, y) if y.abs().max() > 0 else float(x.abs().max())
                   for x, y in zip(run["cots"][k], ref["cots"][k])],
                  int(flip.sum()),
                  float(b[flip].abs().max()) if flip.any() else 0.0)
    return out


def grad_stats(got, want):
    head_d, head_w, trunk_d, trunk_w = [], [], [], []
    head = (0.0, "")
    trunk = (0.0, "", 0.0)
    zero = (0.0, "", 0.0)
    for k, w in want.items():
        g = got[k]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        if k.startswith(TRUNK):
            if TRUE_ZERO.search(k):
                if err > zero[0]:
                    zero = (err, k, scale)
                continue
            trunk_d.append((g - w).reshape(-1))
            trunk_w.append(w.reshape(-1))
            if scale > 0 and err / scale > trunk[0]:
                trunk = (err / scale, k, scale)
        else:
            head_d.append((g - w).reshape(-1))
            head_w.append(w.reshape(-1))
            if scale > 0 and err / scale > head[0]:
                head = (err / scale, k)
    l2 = lambda d, w: float(torch.cat(d).norm() / torch.cat(w).norm())
    return {"head_l2": l2(head_d, head_w), "head_leaf": head[0],
            "head_leaf_name": head[1], "trunk_leaf": trunk[0],
            "trunk_leaf_name": trunk[1], "trunk_leaf_scale": trunk[2],
            "trunk_l2": l2(trunk_d, trunk_w),
            "zero_abs": zero[0], "zero_name": zero[1],
            "zero_scale": zero[2]}


def fmt(s):
    return (f"head L2 {s['head_l2']:.3g} leaf {s['head_leaf']:.3g} "
            f"({s['head_leaf_name']}); trunk leaf {s['trunk_leaf']:.3g} "
            f"({s['trunk_leaf_name']}, max |g| "
            f"{s['trunk_leaf_scale']:.3g}) L2 {s['trunk_l2']:.3g}; "
            f"true-zero leaves |diff| {s['zero_abs']:.3g} "
            f"({s['zero_name']}, its max |g| {s['zero_scale']:.3g})")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_dp_head needs a CUDA card")
    c = _smoke()
    from voicepuppet_torch.parallel.spawn import run_ranks
    card = c.card_line()
    t0 = time.perf_counter()
    plain = run_step(None, "plain", 1.0, None)
    m = valid(plain["seq_len"], plain["frame"].shape[1], 0)
    eps = float(plain["frame"][m].abs().median())
    signs = [torch.sign(plain["frame"]), torch.sign(plain["vid"])]
    plain = run_step(None, "plain", eps, signs)
    print(f"probe_dp_head: median |r| over the valid frames {eps:.6g}; "
          f"{card}", flush=True)
    runs = {v: run_step(None, v, eps, signs) for v in RUNS}
    with tempfile.TemporaryDirectory() as work:
        signs_path = os.path.join(work, "signs.pt")
        torch.save(signs, signs_path)
        paths = run_ranks(rank_main, 2, eps, signs_path, work,
                          device="cuda:0", backend="gloo", timeout=800)
        ranks = [torch.load(p, weights_only=True) for p in paths]
    r0, r1 = ranks
    runs["2 ranks"] = dict(
        r0, out=torch.cat([r0["out"], r1["out"]]),
        frame=torch.cat([r0["frame"], r1["frame"]]),
        vid=torch.cat([r0["vid"], r1["vid"]]),
        seq_len=torch.cat([r0["seq_len"], r1["seq_len"]]),
        # a rank's loss is the mean over its half of the rows
        acts={k: torch.cat([r0["acts"][k], r1["acts"][k]])
              for k in r0["acts"]},
        cots={k: 0.5 * torch.cat([r0["cots"][k], r1["cots"][k]])
              for k in r0["cots"]})
    for name, run in runs.items():
        fw = forward_stats(run, plain)
        worst = sorted(fw["bn"], key=lambda b: -b[1])[:3]
        print(f"[{name}] forward: out {fw['out_rel']:.3g} of its max; "
              f"residual sign flips {fw['sign_flips']} (largest flipped "
              f"|r| {fw['largest_flipped_abs_r']:.3g}, residual max "
              f"|diff| {fw['residual_max_diff']:.3g}); BN mean shift in "
              f"stds, worst (index, shift, its max |mean|/std): "
              f"{[(b[0], f'{b[1]:.3g}', f'{b[2]:.3g}') for b in worst]}; "
              f"BN 5 shift/max|mean| {fw['bn'][5][3]:.3g} with max "
              f"|mean|/std {fw['bn'][5][2]:.3g}", flush=True)
        for k, (a, g, rows, n, v) in trace_stats(run, plain).items():
            print(f"[{name}] {k}: output {a:.3g} of its max, l1 cotangent "
                  f"{g:.3g} of its max; by row {[f'{x:.2g}' for x in rows]}"
                  f"; {n} outputs of the other sign (largest |value| "
                  f"{v:.3g})", flush=True)
        for form, g in run["grads"].items():
            s = grad_stats(g, plain["grads"][form])
            print(f"[{name}] {form}: {fmt(s)}", flush=True)
        if name == "2 ranks":
            for form, g in run["grads"].items():
                s = grad_stats({k: 2 * v for k, v in g.items()},
                               plain["grads"][form])
                print(f"[{name}] {form}, twice the average: {fmt(s)}",
                      flush=True)
            s = grad_stats(r0["local"], plain["grads"]["l1"])
            print(f"[{name}] l1, rank 0 not averaged: {fmt(s)}", flush=True)
    print(f"probe_dp_head: {time.perf_counter() - t0:.1f} s; {card}")


if __name__ == "__main__":
    main()
