"""Each layer of the PixRefer generator alone at its serving input shape,
with an analytic FLOP count, on the card.

Port of experiments/profile_pixrefer_layers.py: the serving configuration
(bf16 activations from float32 parameters, B = 16 frames, 512², ngf 64).
Each layer is the model's (activation -> 4x4 stride-2 conv or transposed
conv -> StatelessBatchNorm with float32 moments) with seeded weights; the
whole forward is timed too, so (sum of layers - whole) shows what running
them together saves.  Rates are against the H100's dense peak for the
activation dtype (989 TFLOP/s bf16, 67 TFLOP/s float32), not a TPU's.
Also the space-to-depth stem (a 4x4/s2 SAME conv equals pad 1, pack 2x2
blocks into channels, a 2x2/s1 VALID conv), checked against the stem's
conv before it is timed.  Each variant K times back to back with a
carried dependence, interleaved rounds, per-variant minima (``_timing``).

    python -m voicepuppet_torch.experiments.profile_pixrefer_layers [--k 16 --rounds 6]
"""

import sys

import numpy as np
import torch
import torch.nn.functional as F

from voicepuppet_torch.experiments import _common
from voicepuppet_torch.models import pixrefer as px

PEAK_TFLOPS = {torch.bfloat16: 989.0, torch.float32: 67.0}   # H100 SXM
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STEM_BAND = 2e-2        # of the output's scale: bf16 reassociation


def gen_spec(ngf, s):
    """(kind, name, h_in, c_in, c_out, activation, bn) of every layer of
    ``pixrefer.Generator``, in its order."""
    spec = [("conv", "encoder_1", s, 6, ngf, None, False)]
    enc = ((ngf, ngf * 2), (ngf * 2, ngf * 2), (ngf * 2, ngf * 4))
    h = s // 2
    for i, (ci, co) in enumerate(enc):
        spec.append(("conv", f"encoder_{i + 2}", h, ci, co, "lrelu", True))
        h //= 2
    spec.append(("conv", "encoder_fg_1", s, 3, ngf, None, False))
    h = s // 2
    for i, (ci, co) in enumerate(enc):
        spec.append(("conv", f"encoder_fg_{i + 2}", h, ci, co, "lrelu",
                     True))
        h //= 2
    h = s // 16
    for i, (ci, co) in enumerate(((ngf * 8, ngf * 4), (ngf * 4, ngf * 8),
                                  (ngf * 8, ngf * 8), (ngf * 8, ngf * 8))):
        spec.append(("conv", f"merged_encoder_{i + 2}", h, ci, co, "lrelu",
                     True))
        h //= 2
    h = s // 256
    for name, ci, co in (("merged_decoder_5", ngf * 8, ngf * 8),
                         ("merged_decoder_4", ngf * 16, ngf * 8),
                         ("merged_decoder_3", ngf * 16, ngf * 4),
                         ("merged_decoder_2", ngf * 8, ngf * 4),
                         ("merged2_decoder_4", ngf * 8, ngf * 2),
                         ("merged2_decoder_3", ngf * 4, ngf * 2),
                         ("merged2_decoder_2", ngf * 4, ngf)):
        spec.append(("deconv", name, h, ci, co, "relu", True))
        h *= 2
    spec.append(("deconv", "decoder_1", h, ngf * 2, 4, "relu", False))
    return spec


def layer_flops(kind, b, h_in, c_in, c_out):
    """2 x MACs of a 4x4 stride-2 (transposed) conv at batch ``b``: 16
    c_in c_out per pixel of the small side."""
    small = h_in // 2 if kind == "conv" else h_in
    return 2.0 * b * small * small * 16 * c_in * c_out


def make_layer(kind, c_in, c_out, act, bn, dt, rng, device):
    """A standalone (activation -> conv -> BN) layer of the generator,
    weights N(0, 0.02) from ``rng``."""
    mod = (px.GenConv(c_in, c_out) if kind == "conv"
           else px.GenDeconv(c_in, c_out))
    with torch.no_grad():
        for q in mod.parameters():
            q.copy_(torch.as_tensor(rng.randn(*q.shape).astype(np.float32)
                                    * 0.02))
    mod.to(device)
    norm = px.StatelessBatchNorm(c_out).to(device) if bn else None

    def f(x):
        if act == "lrelu":
            x = px.lrelu(x)
        elif act == "relu":
            x = F.relu(x)
        y = mod(x)
        return norm(y) if norm is not None else y
    return f


def s2d_stem(c_in, c_out, dt, rng, device):
    """(space-to-depth stem, the stem's conv) with one seeded kernel."""
    conv = px.GenConv(c_in, c_out)
    with torch.no_grad():
        conv.Conv_0.weight.copy_(torch.as_tensor(
            rng.randn(c_out, c_in, 4, 4).astype(np.float32) * 0.02))
    conv.to(device)
    w = conv.Conv_0.weight.detach()
    # [co, ci, kh2, p, kw2, q] -> [co, (ci, p, q), kh2, kw2]
    k2 = (w.reshape(c_out, c_in, 2, 2, 2, 2).permute(0, 1, 3, 5, 2, 4)
          .reshape(c_out, c_in * 4, 2, 2))
    bias = conv.Conv_0.bias.detach()

    def s2d(x):
        b, c, h, wd = x.shape
        xp = F.pad(x, (1, 1, 1, 1))
        xp = (xp.reshape(b, c, (h + 2) // 2, 2, (wd + 2) // 2, 2)
              .permute(0, 1, 3, 5, 2, 4).reshape(b, c * 4, (h + 2) // 2,
                                                 (wd + 2) // 2))
        return F.conv2d(xp, k2.to(x.dtype), bias.to(x.dtype))

    return s2d, conv


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    dt = DTYPES[args.dtype]
    cfg = _common.config_for(args.scale)
    s, ngf, b = cfg.pixrefer.img_size, cfg.pixrefer.ngf, args.batch
    rng = np.random.RandomState(0)

    def rand(shape):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) * 2 - 1,
                               device=dev).to(dt)

    spec = gen_spec(ngf, s)
    gen = px.init_pixrefer_(px.Generator(ngf, 4, dt),
                            torch.Generator().manual_seed(0))
    for m in gen.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.to(dt)
    gen.to(dev)
    full_fg = rand((b, s, s, 3)).float()
    cases = {"FULL G forward": (lambda x: gen(x, full_fg),
                                rand((b, s, s, 6)).float())}
    flops = {"FULL G forward": sum(layer_flops(k, b, h, ci, co)
                                   for k, _, h, ci, co, _, _ in spec)}
    for kind, name, h_in, c_in, c_out, act, bn in spec:
        cases[name] = (make_layer(kind, c_in, c_out, act, bn, dt, rng, dev),
                       rand((b, c_in, h_in, h_in)))
        flops[name] = layer_flops(kind, b, h_in, c_in, c_out)
    with torch.inference_mode():
        for ci in (6, 3):
            s2d, conv = s2d_stem(ci, ngf, dt, rng, dev)
            x = rand((b, ci, s, s))
            got, want = s2d(x).float(), conv(x).float()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            print(f"s2d stem parity ({ci} ch): max|d| {err:.3e} (scale "
                  f"{scale:.3e})", flush=True)
            if not err <= STEM_BAND * scale:
                raise AssertionError(f"s2d stem ({ci} ch) off the conv by "
                                     f"{err} (scale {scale})")
            cases[f"stem{ci} s2d (lever)"] = (s2d, x)
            flops[f"stem{ci} s2d (lever)"] = layer_flops("conv", b, s, ci,
                                                         ngf)
        per, _, _ = _common.timed(cases, args.k, args.rounds, dev)
    peak = PEAK_TFLOPS[dt]
    print(f"\nFINAL PER-LAYER PROFILE ({args.dtype} activations, B={b}, "
          f"{s}², ngf {ngf}, K={args.k}; peak {peak:g} TFLOP/s) on "
          f"{_common.device_line(dev)}:")
    print(f"  {'layer':26s} {'ms':>9s} {'GFLOP':>8s} {'TFLOP/s':>8s} "
          f"{'MFU%':>6s}")
    names = {n for _, n, *_ in spec}
    total = 0.0
    rows = {}
    for name, sec in per.items():
        gf = flops[name] / 1e9
        tf = gf / sec / 1e3 if sec > 0 else float("nan")
        rows[name] = (sec * 1e3, gf, tf)
        print(f"  {name:26s} {sec * 1e3:9.4f} {gf:8.2f} {tf:8.2f} "
              f"{100 * tf / peak:6.2f}", flush=True)
        if name in names:
            total += sec
    full = per["FULL G forward"]
    print(f"\n  sum of layers {total * 1e3:.3f} ms vs whole forward "
          f"{full * 1e3:.3f} ms (delta {(total - full) * 1e3:+.3f} ms)",
          flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
