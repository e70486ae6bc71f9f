"""A/Bs of two reformulations of the PixRefer generator's edge layers, on
the card.

Port of experiments/profile_pixrefer_levers.py (bf16, B = 16, 512², ngf
64); each lever is checked on the device against the production layer
(``GenConv`` / ``GenDeconv``) before it is timed:

* stems (4x4 stride-2 conv, 6 or 3 input channels): explicit im2col, the
  16 taps of each output pixel unfolded into channels, then ONE
  [B*H'*W', 16 ci] @ [16 ci, co] matmul (float32 accumulation);
* transposed convs (4x4 stride 2, padding 1): the parity decomposition.
  Output row 2m reads input rows m-1, m through kernel rows 3, 1; row
  2m+1 reads rows m, m+1 through kernel rows 2, 0 (columns alike), so
  each of the four (row, column) parities is a dense 2x2 stride-1 conv of
  the input padded by one, and the four are interleaved; no product
  lands on an inserted zero.

The levers live here only: no production module changes.  Each variant K
times back to back with a carried dependence, interleaved rounds,
per-variant minima (``_timing``, CUDA events).

    python -m voicepuppet_torch.experiments.profile_pixrefer_levers [--k 16 --rounds 6]
"""

import sys

import numpy as np
import torch
import torch.nn.functional as F

from voicepuppet_torch.experiments import _common
from voicepuppet_torch.models import pixrefer as px

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# max |lever - production| against the output's scale: bf16 reassociation
# (the JAX script's band); float32 runs are held to 1e-5
BANDS = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _seeded(mod, rng, device):
    with torch.no_grad():
        for q in mod.parameters():
            q.copy_(torch.as_tensor(rng.randn(*q.shape).astype(np.float32)
                                    * 0.02))
    return mod.to(device)


def im2col_stem(conv: px.GenConv):
    """The 4x4/s2 SAME conv of ``conv`` as unfold + one matmul."""
    w = conv.Conv_0.weight.detach()
    co, ci = w.shape[0], w.shape[1]
    kmat = w.reshape(co, ci * 16)
    bias = conv.Conv_0.bias.detach()

    def f(x):
        b, _, h, wd = x.shape
        cols = F.unfold(F.pad(x, (1, 1, 1, 1)), 4, stride=2)   # [B,16ci,L]
        y = torch.matmul(kmat.to(x.dtype), cols)               # [B,co,L]
        return (y + bias.to(x.dtype)[None, :, None]).reshape(
            b, co, h // 2, wd // 2)
    return f


def parity_deconv(deconv: px.GenDeconv):
    """The 4x4/s2 padding-1 transposed conv of ``deconv`` as four 2x2
    stride-1 convs of the input padded by one, interleaved."""
    w = deconv.ConvTranspose_0.weight.detach()      # [ci, co, 4, 4]
    bias = deconv.ConvTranspose_0.bias.detach()
    # parity p: (first padded row, kernel rows for the two taps)
    taps = {0: (0, [3, 1]), 1: (1, [2, 0])}
    kernels = {}
    for p, (_, kr) in taps.items():
        for q, (_, kc) in taps.items():
            kernels[(p, q)] = w[:, :, kr][:, :, :, kc].permute(
                1, 0, 2, 3).contiguous()             # [co, ci, 2, 2]

    def f(x):
        b, _, h, wd = x.shape
        xp = F.pad(x, (1, 1, 1, 1))
        outs = {}
        for (p, q), k in kernels.items():
            r0, c0 = taps[p][0], taps[q][0]
            outs[(p, q)] = F.conv2d(xp[:, :, r0:r0 + h + 1, c0:c0 + wd + 1],
                                    k.to(x.dtype), bias.to(x.dtype))
        row0 = torch.stack([outs[(0, 0)], outs[(0, 1)]], dim=-1)
        row1 = torch.stack([outs[(1, 0)], outs[(1, 1)]], dim=-1)
        y = torch.stack([row0, row1], dim=3)          # [B,co,h,2,w,2]
        return y.reshape(b, y.shape[1], 2 * h, 2 * wd)
    return f


def lever_cases(ngf, s, b, dt, rng, device):
    """{layer: (production, lever, input)} of the JAX script."""
    def rand(shape):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32) * 2 - 1,
                               device=device).to(dt)
    out = {}
    for name, ci in (("encoder_1", 6), ("encoder_fg_1", 3)):
        conv = _seeded(px.GenConv(ci, ngf), rng, device)
        out[name] = (conv, im2col_stem(conv), rand((b, ci, s, s)))
    for name, ci, co, h in (("decoder_1", 2 * ngf, 4, s // 2),
                            ("merged2_decoder_2", 4 * ngf, ngf, s // 4)):
        deconv = _seeded(px.GenDeconv(ci, co), rng, device)
        out[name] = (deconv, parity_deconv(deconv), rand((b, ci, h, h)))
    return out


def check_levers(levers, dt):
    """{layer: (max |lever - production|, scale)}; raises outside
    ``BANDS[dt]``."""
    got = {}
    for name, (base, fast, x) in levers.items():
        want = base(x).float()
        err = float((fast(x).float() - want).abs().max())
        scale = float(want.abs().max())
        print(f"parity {name}: max|d| = {err:.3e} (scale {scale:.3e})",
              flush=True)
        if not err <= BANDS[dt] * scale:
            raise AssertionError(f"lever {name} off the production layer by "
                                 f"{err} (scale {scale})")
        got[name] = (err, scale)
    return got


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
    with torch.inference_mode():
        levers = lever_cases(ngf, s, b, dt, rng, dev)
        parity = check_levers(levers, dt)
        cases = {}
        for name, (base, fast, x) in levers.items():
            cases[f"{name} base"] = (base, x)
            cases[f"{name} lever"] = (fast, x)
        per, mins1, minsk = _common.timed(cases, args.k, args.rounds, dev)
    print(f"\nFINAL LEVER A/B ({args.dtype}, B={b}, {s}², K={args.k}) on "
          f"{_common.device_line(dev)}:")
    for name, sec in per.items():
        print(f"  {name:28s} {sec * 1e3:9.4f} ms   (t1="
              f"{mins1[name] * 1e3:.3f} tK={minsk[name] * 1e3:.3f})",
              flush=True)
    out = {name: sec * 1e3 for name, sec in per.items()}
    out["parity"] = parity
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
