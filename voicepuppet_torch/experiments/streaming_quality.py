"""Quality against latency for streaming synthesis: the expression
coefficients of the streamed run against the whole-clip batch pass, for
(chunk, ctx_right) presets from the batch-faithful default to fully
causal, beside each preset's algorithmic latency at 25 fps.

Port of experiments/streaming_quality.py.  An exactness curve with no
timing: the GRU streams exactly, only the conv trunk sees a truncated
window, so shrinking ``ctx_right`` and ``chunk`` trades coefficient
fidelity for latency.  The JAX script's setting: BFMNet at width-mult
0.25 (64 wide) from random weights, the 12² synthetic BFM (seed 3), a
96-frame clip of a 220 Hz tone with noise, 0.25 s pcm packets, zero
ear signals on both paths; the interior is frames 32-80 (a full
``ctx_left`` history).  Absolute errors mean something only against the
printed coefficient scale and as ratios between presets.

    python -m voicepuppet_torch.experiments.streaming_quality [--device cpu]
"""

import dataclasses
import sys

import numpy as np
import torch

from voicepuppet_torch.config import Config
from voicepuppet_torch.experiments import _common
from voicepuppet_torch.face3d import bfm as bfm_mod
from voicepuppet_torch.pipeline.streaming import StreamingCoeffPredictor
from voicepuppet_torch.pipeline.synthesize import SynthesisAssets

PRESETS = (("batch-faithful (default)", 16, 12),
           ("low-latency", 8, 6),
           ("interactive", 4, 3),
           ("causal", 4, 0))
FRAMES = 96
INTERIOR = slice(32, 80)


class ZeroRng:
    """The streamed path's ear signal, zero as on the batch path."""

    def rand(self, *shape):
        return np.zeros(shape)


def script_config() -> Config:
    """The JAX script's configuration."""
    base = Config()
    return dataclasses.replace(
        base,
        bfmnet=dataclasses.replace(base.bfmnet, backbone_width_mult=0.25,
                                   thinresnet_output_channels=64,
                                   encode_embedding_size=64,
                                   rnn_hidden_size=64),
        pixrefer=dataclasses.replace(base.pixrefer, ngf=8, ndf=8,
                                     img_size=256))


def clip(cfg, frames: int = FRAMES) -> np.ndarray:
    rng = np.random.RandomState(0)
    t = np.arange(frames * cfg.frame_wav_scale) / cfg.mel.sample_rate
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.randn(t.shape[0])).astype(np.float32)


@torch.inference_mode()
def batch_coeffs(synth, pcm: np.ndarray, frames: int) -> np.ndarray:
    """The whole-clip pass, zero ears -> [T, 64]."""
    cfg = synth.cfg
    n = cfg.pcm_length_for_frames(frames)
    pcm_pad = np.pad(pcm, (0, max(0, n - pcm.shape[0])))[:n]
    dev = synth.device
    mel = synth.frontend(torch.as_tensor(pcm_pad[None], device=dev))
    out = synth.bfmnet(torch.zeros((1, frames, 1), device=dev), mel,
                       torch.full((1,), frames, dtype=torch.int64,
                                  device=dev))
    return out[0].float().cpu().numpy()


def streamed_coeffs(synth, pcm: np.ndarray, chunk: int,
                    ctx_right: int) -> np.ndarray:
    sp = StreamingCoeffPredictor(synth, chunk=chunk, ctx_right=ctx_right)
    sp._rng = ZeroRng()
    step = synth.cfg.mel.sample_rate // 4
    blocks = []
    for off in range(0, pcm.shape[0], step):
        blocks += sp.feed(pcm[off:off + step])
    blocks += sp.flush()
    return torch.cat(blocks).float().cpu().numpy()


def preset_errors(synth, pcm: np.ndarray, frames: int = FRAMES):
    """[{preset, chunk, ctx_right, mae, rel, interior_mae, lookahead_ms,
    first_block_ms}] and the coefficient scale."""
    ref = batch_coeffs(synth, pcm, frames)
    scale = float(np.abs(ref).mean())
    fps = synth.cfg.frame_rate
    rows = []
    for name, chunk, ctx_right in PRESETS:
        got = streamed_coeffs(synth, pcm, chunk, ctx_right)
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: streamed {got.shape} vs batch "
                                 f"{ref.shape}")
        mae = float(np.abs(got - ref).mean())
        rows.append(dict(
            preset=name, chunk=chunk, ctx_right=ctx_right, mae=mae,
            rel=mae / scale,
            interior_mae=float(np.abs(got[INTERIOR] - ref[INTERIOR]).mean()),
            lookahead_ms=1000.0 * ctx_right / fps,
            first_block_ms=1000.0 * (chunk + ctx_right) / fps))
    return rows, scale


def main(argv=None):
    args = _common.experiment_parser(__doc__).parse_args(argv)
    cfg = script_config()
    fmodel = bfm_mod.synthetic_bfm(num_theta=12, num_phi=12, seed=3)
    synth, _ = SynthesisAssets.demo(cfg, face_model=fmodel,
                                    device=args.device)
    rows, scale = preset_errors(synth, clip(cfg))
    synth.close()
    print(f"clip: {FRAMES} frames @ {cfg.frame_rate} fps; coeff scale "
          f"mean|exp_ref| = {scale:.4e} ({_common.device_line(args.device)})"
          f"\n")
    print(f"{'preset':26s} {'chunk':>5s} {'ctxR':>4s} {'MAE':>10s} "
          f"{'rel':>7s} {'interiorMAE':>11s} {'lookahead':>9s} "
          f"{'1st-block':>9s}")
    for r in rows:
        print(f"{r['preset']:26s} {r['chunk']:5d} {r['ctx_right']:4d} "
              f"{r['mae']:10.3e} {r['rel']:6.1%} {r['interior_mae']:11.3e} "
              f"{r['lookahead_ms']:7.0f}ms {r['first_block_ms']:7.0f}ms",
              flush=True)
    print("\n(1st-block = frames that must arrive before the first block "
          "can compute; add the measured block wall of profile_serving for "
          "the wall-clock first frame)")
    return {"scale": scale, "rows": rows}


if __name__ == "__main__":
    main(sys.argv[1:])
