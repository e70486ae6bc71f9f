"""How far the served bfloat16 generator lands from float32, by input and
layer by layer.

The PixRefer G of ``graft_entry.entry()`` (seed-0 weights) runs twice on
the generator inputs that ``Synthesizer.frame_program_for(graft_entry.
entry_identity())`` builds (the entry's frame step) from the entry's
mesh and coefficients: in float32, and as the Synthesizer serves it
(``set_conv_dtype(bfloat16)``: bf16 convs, float32 batch moments and
compositing).  The input sets differ in the references and the batch;
the background is black in all, as in the entry and on the main path:

* ``zero``: the entry's example arguments (4 frames, zero references);
* ``fg``, ``face``: the fg or the face3d reference from the bench's
  panel, the other zero;
* ``refs``: both references from the panel (the main path's kind);
* ``zero32``, ``refs32``: ``zero`` and ``refs`` at 32 frames (the main
  path's chunk; the coefficients ``demo_coeff(batch=32)``).

For each set: the composited output's mean and max |diff| in 8-bit codes
(what ``chip_smoke.py`` gates at GEN_BF16_MEAN_CODES on the main path's
inputs), and for each StatelessBatchNorm the elements it averages per
channel, the contrast of its float32 input (median over channels of the
standard deviation over the root mean square: a small contrast means a
near-constant field, where bf16's rounding of the conv output, 2^-9 of
its magnitude, is a large share of what the norm scales up) and the
relative error after it (mean |bf16 - float32| / mean |float32|).

    python -m voicepuppet_torch.experiments.gen_bf16_inputs [--device cuda] [--scale full]
"""

from __future__ import annotations

import copy
import json
import sys

import torch

from voicepuppet_torch import bench, graft_entry
from voicepuppet_torch.experiments import _common


def input_sets(cfg, args, face_model, device):
    """``{name: (coeff [C,257], face3d_ref [S,S,3], fg_ref [S,S,3])}``."""
    from voicepuppet_torch.face3d import bfm
    _, coeff, _, _, face3d_ref, fg_ref = args
    s = cfg.pixrefer.img_size
    _, panel = bench.workload(cfg, 0.0)
    face = torch.as_tensor(panel[:, s:2 * s], device=device)
    fg = torch.as_tensor(panel[:, :s] * panel[:, 2 * s:], device=device)
    coeff32 = torch.as_tensor(bfm.demo_coeff(face_model, batch=32),
                              dtype=torch.float32, device=device)
    return {"zero": (coeff, face3d_ref, fg_ref),
            "fg": (coeff, face3d_ref, fg),
            "face": (coeff, face, fg_ref),
            "refs": (coeff, face, fg),
            "zero32": (coeff32, face3d_ref, fg_ref),
            "refs32": (coeff32, face, fg)}


def _contrast(x: torch.Tensor) -> float:
    """Median over channels of std / rms of an NCHW tensor, in float32."""
    x = x.float()
    std = x.std(dim=(0, 2, 3), unbiased=False)
    rms = x.square().mean(dim=(0, 2, 3)).sqrt()
    return float((std / rms.clamp_min(1e-30)).median())


def _bn_readings(gen):
    """Forward hooks on every StatelessBatchNorm of ``gen``: each call
    appends (elements per channel, the contrast of its input, its output
    in float32) to the returned list."""
    got, hooks = [], []
    for i in range(17):
        bn = getattr(gen.generator, f"StatelessBatchNorm_{i}")
        hooks.append(bn.register_forward_hook(
            lambda m, a, out: got.append((a[0].numel() // a[0].shape[1],
                                          _contrast(a[0]), out.float()))))
    return got, hooks


def layer_table(rows32, rows16):
    """Per norm: elements per channel, contrast of its float32 input,
    relative error of its bf16 output."""
    return [{"elements": n, "contrast": contrast,
             "rel_err": float((y16 - y32).abs().mean() / y32.abs().mean())}
            for (n, contrast, y32), (_, _, y16) in zip(rows32, rows16)]


def measure(cfg, device):
    """``{set: {"mean_codes", "max_codes", "layers": [...]}}``."""
    from voicepuppet_torch.face3d import bfm
    from voicepuppet_torch.pipeline import synthesize as syn
    dev = torch.device(device)
    _, args = graft_entry.entry(dev, cfg)
    face_model = bfm.synthetic_bfm(num_theta=graft_entry.ENTRY_GRID,
                                   num_phi=graft_entry.ENTRY_GRID, seed=0)
    bfm_state, _ = syn.SynthesisAssets.init_trees(cfg, 0)
    synth = syn.Synthesizer(cfg, face_model, bfm_state, args[0].state_dict(),
                            chunk=graft_entry.ENTRY_CHUNK,
                            gan_dtype=torch.float32, device=dev)
    gen32 = synth.gen
    gen16 = copy.deepcopy(gen32).set_conv_dtype(torch.bfloat16).eval()
    prog = synth.frame_program_for(graft_entry.entry_identity(cfg))
    s = cfg.pixrefer.img_size
    bg_pool = torch.zeros((1, s, s, 3), device=dev)
    result = {}
    for name, (coeff, face3d_ref, fg_ref) in input_sets(
            cfg, args, face_model, dev).items():
        c = coeff.shape[0]
        captured = []
        hook = gen32.register_forward_hook(
            lambda m, a, out: captured.append(a))
        with torch.inference_mode():
            prog(coeff, torch.zeros((c, 3), device=dev), bg_pool,
                 torch.zeros((c,), dtype=torch.int64, device=dev),
                 face3d_ref, fg_ref)
        hook.remove()
        rows = {}
        outs = {}
        with torch.inference_mode():
            for label, gen in (("f32", gen32), ("bf16", gen16)):
                rows[label], hooks = _bn_readings(gen)
                outs[label] = gen(*captured[0])[0]
                for h in hooks:
                    h.remove()
        d = (outs["bf16"] - outs["f32"]).abs() * 127.5
        result[name] = {"frames": c, "mean_codes": float(d.mean()),
                        "max_codes": float(d.max()),
                        "layers": layer_table(rows["f32"], rows["bf16"])}
        del captured, rows, outs
    synth.close()
    return result


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    args = p.parse_args(argv)
    cfg = _common.config_for(args.scale)
    res = measure(cfg, args.device)
    print(f"bf16 generator vs float32 by input at {cfg.pixrefer.img_size}² "
          f"ngf {cfg.pixrefer.ngf} on {_common.device_line(args.device)}",
          flush=True)
    for name, r in res.items():
        print(f"  {name:6s} {r['frames']:2d} frames: output mean "
              f"{r['mean_codes']:.4f} codes, max {r['max_codes']:.3f}",
              flush=True)
    print("  norm: elements per channel at 4 frames, then per set contrast "
          "/ relative error", flush=True)
    for i in range(len(res["zero"]["layers"])):
        cells = "  ".join(f"{res[n]['layers'][i]['contrast']:.3g}/"
                          f"{res[n]['layers'][i]['rel_err']:.3g}"
                          for n in res)
        print(f"  {i:2d} {res['zero']['layers'][i]['elements']:7d}  {cells}",
              flush=True)
    print(json.dumps({n: {k: r[k] for k in ("frames", "mean_codes",
                                              "max_codes")}
                      for n, r in res.items()}), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
