"""A/B of the render_frames tail bucket on the card: the last chunk padded
to a power of two (``Synthesizer._tail_bucket`` True) or to the whole
chunk (False).

Port of experiments/profile_tail_bucket.py: an 8-second clip at chunk 32
(201 frames: six full chunks and a 9-frame tail, bucketed to 16 or
padded to 32), both variants in one process, interleaved A/B/A/B, the
best frames/s of each.  Before timing, the full chunks of the two
variants must be byte-identical: only the tail chunk's batch-stat BN
sees a different batch.

    python -m voicepuppet_torch.experiments.profile_tail_bucket [--pairs 4]
"""

import sys
import time

import numpy as np

from voicepuppet_torch.experiments import _common
from voicepuppet_torch.pipeline.synthesize import (SynthesisAssets,
                                                   constant_background)


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--chunk", type=int, default=32)
    args = p.parse_args(argv)
    cfg = _common.config_for(args.scale)
    synth, identity = SynthesisAssets.demo(
        cfg, face_model=_common.face_model_for(args.scale),
        chunk=args.chunk, device=args.device)
    sr = cfg.mel.sample_rate
    pcm = (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(int(args.seconds * sr))
                        / sr)).astype(np.float32)
    s = cfg.pixrefer.img_size
    panel = np.random.RandomState(0).rand(s, 3 * s, 3).astype(np.float32)

    def run():
        bg = constant_background(np.zeros((s, s, 3), np.float32))
        t0 = time.perf_counter()
        frames = synth.synthesize(panel, pcm, identity, backgrounds=bg)
        return frames, frames.shape[0] / (time.perf_counter() - t0)

    print("warm-up (both variants) ...", flush=True)
    first = {}
    try:
        for variant, tb in (("bucket", True), ("pad_full", False)):
            synth._tail_bucket = tb
            first[variant] = run()[0]
        t = first["bucket"].shape[0]
        full = t - t % args.chunk
        if t % args.chunk == 0 or not np.array_equal(
                first["bucket"][:full], first["pad_full"][:full]):
            raise AssertionError(f"{t} frames: the full chunks must be "
                                 f"byte-identical across the variants and "
                                 f"a tail must exist")
        tail = np.abs(first["bucket"][full:].astype(np.int16)
                      - first["pad_full"][full:].astype(np.int16))
        print(f"{t} frames: full chunks byte-identical; tail of "
              f"{t - full} frames mean |diff| {tail.mean():.4f} codes "
              f"(the tail chunk's BN batch differs)", flush=True)
        best = {"bucket": 0.0, "pad_full": 0.0}
        runs = {"bucket": [], "pad_full": []}
        for i in range(args.pairs):
            for variant, tb in (("bucket", True), ("pad_full", False)):
                synth._tail_bucket = tb
                fps = run()[1]
                runs[variant].append(fps)
                best[variant] = max(best[variant], fps)
                print(f"pair {i} {variant:8s}: {fps:8.2f} frames/s",
                      flush=True)
    finally:
        synth._tail_bucket = True
        synth.close()
    print(f"\nFINAL per-variant best-of on "
          f"{_common.device_line(args.device)}:")
    for v in ("bucket", "pad_full"):
        print(f"  {v:8s}: best {best[v]:8.2f} frames/s   runs "
              f"{[round(x, 2) for x in runs[v]]}")
    print(f"  bucket/pad_full speedup: {best['bucket'] / best['pad_full']:.3f}x",
          flush=True)
    return {"best": best, "runs": runs}


if __name__ == "__main__":
    main(sys.argv[1:])
