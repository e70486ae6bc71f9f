"""Serving latency: the streaming block wall and the BFMNet whole-clip
coefficient pass at float32 against the bf16 trunk.

Port of experiments/profile_serving.py:

1. Streaming block latency: pcm in -> frames out, host wall per block at
   chunk 16 and 8 (the 189² mesh, 512² frames, bf16 G, YUV 4:2:0), after
   a first feed that primes the lookahead and builds the kernels; each
   block must hold exactly ``chunk`` frames.
2. The BFMNet coefficient pass over a T = 256 bucket (full width) at
   float32 and with the bf16 conv trunk, K back-to-back passes with a
   carried dependence, interleaved rounds, per-variant minima, CUDA
   events (``_timing``).

    python -m voicepuppet_torch.experiments.profile_serving [--which ab|stream|all]
"""

import sys
import time

import numpy as np
import torch

from voicepuppet_torch.audio.frontend import MelFrontend
from voicepuppet_torch.experiments import _common
from voicepuppet_torch.models.bfmnet import BFMNet, init_bfmnet_
from voicepuppet_torch.pipeline.streaming import StreamingSynthesizer
from voicepuppet_torch.pipeline.synthesize import SynthesisAssets


def stream_latency(args, cfg, chunk):
    """ms per block (host wall) of a stream at ``chunk`` -> the list."""
    fm = _common.face_model_for(args.scale)
    synth, identity = SynthesisAssets.demo(cfg, face_model=fm, chunk=chunk,
                                           device=args.device)
    s = cfg.pixrefer.img_size
    panel = np.random.RandomState(0).rand(s, 3 * s, 3).astype(np.float32)
    ss = StreamingSynthesizer(synth, identity, panel[:, s:2 * s],
                              panel[:, :s])
    sr = cfg.mel.sample_rate
    spf = cfg.frame_wav_scale
    total = (chunk + ss.coeffs.ctx_right + 1 + chunk * args.blocks) * spf
    pcm = (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(total) / sr)
           ).astype(np.float32)
    pos = 0

    def feed(nframes):
        nonlocal pos
        block = pcm[pos:pos + nframes * spf]
        pos += nframes * spf
        return ss.feed(block)

    t0 = time.perf_counter()
    out = feed(chunk + ss.coeffs.ctx_right + 1)
    print(f"chunk={chunk}: first block (kernel build) "
          f"{time.perf_counter() - t0:.1f} s, {len(out)} blocks", flush=True)
    lats = []
    for _ in range(args.blocks):
        t0 = time.perf_counter()
        blocks = feed(chunk)
        lats.append((time.perf_counter() - t0) * 1e3)
        if sum(b.shape[0] for b in blocks) != chunk:
            raise AssertionError(f"chunk {chunk}: a feed of {chunk} frames "
                                 f"gave blocks of "
                                 f"{[b.shape[0] for b in blocks]} frames")
    synth.close()
    lats = np.asarray(lats)
    look = 1000.0 * (ss.coeffs.ctx_right + chunk) / cfg.frame_rate
    print(f"chunk={chunk:2d}: pcm->frames wall per block min "
          f"{lats.min():.1f} ms  median {np.median(lats):.1f} ms  max "
          f"{lats.max():.1f} ms  (+ {look:.0f} ms algorithmic lookahead at "
          f"{cfg.frame_rate} fps)", flush=True)
    return lats.tolist()


def bfmnet_ab(args, cfg):
    """ms per whole-clip coefficient pass, {"f32", "bf16"}."""
    dev = torch.device(args.device)
    t = args.frames
    frontend = MelFrontend(cfg.mel, dev)
    pcm = torch.as_tensor(np.random.RandomState(0).randn(
        1, cfg.pcm_length_for_frames(t)).astype(np.float32) * 0.1,
        device=dev)
    ears = torch.zeros((1, t, 1), device=dev)
    seq = torch.full((1,), t, dtype=torch.int64, device=dev)
    state = init_bfmnet_(BFMNet(cfg.bfmnet),
                         torch.Generator().manual_seed(0)).state_dict()
    nets = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        net = BFMNet(cfg.bfmnet, dtype=dt)
        net.load_state_dict(state)
        nets[name] = net.to(dev).eval()
    with torch.inference_mode():
        mel = frontend(pcm)
        cases = {name: (lambda m, net=net: net(ears, m, seq), mel)
                 for name, net in nets.items()}
        per, _, _ = _common.timed(cases, args.k, args.rounds, dev)
    for name, sec in per.items():
        print(f"bfmnet coeff pass T={t} {name}: {sec * 1e3:.2f} ms",
              flush=True)
    return {name: sec * 1e3 for name, sec in per.items()}


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--which", choices=("all", "ab", "stream"), default="all")
    p.add_argument("--chunks", type=int, nargs="+", default=[16, 8])
    p.add_argument("--blocks", type=int, default=12,
                   help="timed blocks per chunk size")
    p.add_argument("--frames", type=int, default=256,
                   help="the coefficient pass's bucket T")
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--rounds", type=int, default=6)
    args = p.parse_args(argv)
    cfg = _common.config_for(args.scale)
    out = {"device": _common.device_line(args.device)}
    if args.which in ("all", "ab"):
        out["bfmnet_ms"] = bfmnet_ab(args, cfg)
    if args.which in ("all", "stream"):
        out["stream_ms"] = {c: stream_latency(args, cfg, c)
                            for c in args.chunks}
    print(f"FINAL profile_serving on {out['device']}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
