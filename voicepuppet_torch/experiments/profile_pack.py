"""A/B of reformulations of the on-card YUV 4:2:0 pack, each alone.

Port of experiments/profile_pack.py.  Variants, on the same
[16, 512, 512, 3] float32 input (``numpy RandomState(0).rand``):

  v0_chained  the served ``synthesize._pack_yuv420`` (NHWC channel
              slices, the chained multiply-adds fused as XLA fuses them)
  v1_planar   one move of the channels to [3, C, S, S], then v0's scalar
              ops one for one: must equal v0 byte for byte
  v2_matmul   the colour transform as one [.., 3] @ [3, 3] einsum (another
              summation order): within one code of v0, no value off by
              more

Both checks run before anything is timed.  The JAX script found the
einsum 3.3x faster alone and slower inside the frame program
(profile_pack_inprogram.py); this entry point is the "alone" half.
Each variant K times back to back with a carried dependence, interleaved
rounds, per-variant minima (``_timing``, CUDA events).

    python -m voicepuppet_torch.experiments.profile_pack [--k 16 --rounds 6]
"""

import sys

import numpy as np
import torch

from voicepuppet_torch.experiments import _common
from voicepuppet_torch.pipeline.synthesize import _fma, _pack_yuv420

# BT.601 full-range RGB -> YUV as one 3x3 matrix (columns y, u, v): the
# expansion of y = .299r + .587g + .114b, u = (b - y) * .564 + 128,
# v = (r - y) * .713 + 128
_RGB2YUV = np.array([
    [0.299, -0.299 * 0.564, (1 - 0.299) * 0.713],
    [0.587, -0.587 * 0.564, -0.587 * 0.713],
    [0.114, (1 - 0.114) * 0.564, -0.114 * 0.713],
], np.float32)


def _box(p, c, s):
    """2x2 box mean in the served pack's add order."""
    q = p.reshape(c, s // 2, 2, s // 2, 2)
    return (((q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0])
            + q[:, :, 1, :, 1]) * 0.25


def _finish(y, u, v, c, s):
    packed = torch.cat([y.reshape(c, -1), _box(u, c, s).reshape(c, -1),
                        _box(v, c, s).reshape(c, -1)], dim=1)
    return torch.clamp(torch.round(packed), 0, 255).to(torch.uint8)


def pack_planar(frames):
    """v1: v0's scalar ops on planar [3, C, S, S] after one relayout."""
    c, s = frames.shape[0], frames.shape[1]
    f = torch.movedim(torch.clamp(frames, 0.0, 1.0) * 255.0, -1, 0)
    r, g, b = f[0], f[1], f[2]
    y = _fma(b, 0.114, _fma(r, 0.299, g * 0.587))
    u = _fma(b - y, 0.564, torch.full_like(y, 128.0))
    v = _fma(r - y, 0.713, torch.full_like(y, 128.0))
    return _finish(y, u, v, c, s)


def pack_matmul(frames):
    """v2: the colour transform as one einsum (float32, TF32 off)."""
    c, s = frames.shape[0], frames.shape[1]
    f = torch.clamp(frames, 0.0, 1.0) * 255.0
    m = torch.as_tensor(_RGB2YUV, device=frames.device)
    yuv = torch.einsum("chwk,kj->jchw", f, m)
    return _finish(yuv[0], yuv[1] + 128.0, yuv[2] + 128.0, c, s)


def check_packs(frames):
    """(v1's mismatches against v0, v2's values off by more than one code,
    v2's values off by one); raises unless v1 is exact and v2 within one
    code."""
    ref = _pack_yuv420(frames)
    got1 = pack_planar(frames)
    d2 = (ref.int() - pack_matmul(frames).int()).abs()
    ex1 = int((ref != got1).sum())
    over, ties = int((d2 > 1).sum()), int((d2 == 1).sum())
    print(f"parity: v1 mismatches {ex1} (must be 0); v2 {over} values off "
          f"by more than 1 (must be 0), {ties} +-1 ties / {ref.numel()}",
          flush=True)
    if ex1 or over:
        raise AssertionError(f"pack parity: v1 {ex1} mismatches, v2 {over} "
                             f"values off by more than one code")
    return ex1, over, ties


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--size", type=int, default=512)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    rng = np.random.RandomState(0)
    frames = torch.as_tensor(rng.rand(args.chunk, args.size, args.size,
                                      3).astype(np.float32), device=dev)
    with torch.inference_mode():
        check_packs(frames)
        cases = {"v0_chained": (_pack_yuv420, frames),
                 "v1_planar": (pack_planar, frames),
                 "v2_matmul": (pack_matmul, frames)}
        per, _, _ = _common.timed(cases, args.k, args.rounds, dev)
    print(f"\nFINAL per-{args.chunk}-frame-chunk pack time on "
          f"{_common.device_line(dev)}:")
    for name, sec in sorted(per.items(), key=lambda kv: kv[1]):
        print(f"  {name:12s}: {sec * 1e3:9.4f} ms", flush=True)
    return {name: sec * 1e3 for name, sec in per.items()}


if __name__ == "__main__":
    main(sys.argv[1:])
