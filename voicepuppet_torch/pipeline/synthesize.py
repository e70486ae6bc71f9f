"""End-to-end synthesis: one face panel + audio -> video frames.

Port of the serving path of ``voicepuppet_tpu/pipeline/synthesize.py``:

    pcm -> MelFrontend -> BFMNet (bucketed, mask_time) -> coeff splice ->
    3DMM decode (reconstruct_rotation) -> flat z-buffer raster @224²
    (ops.render_colors_auto: the CUDA kernel) -> resize/paste ->
    PixRefer G @512² (per-chunk batch-stat BN) -> composite ->
    YUV 4:2:0 pack -> chunked drain + host unpack

Frames are rendered in chunks of ``chunk``; the last chunk pads to the
smallest power of two >= its length (floor 8, cap ``chunk``), exactly as
the reference does, because the padded zero-coefficient frames enter the
generator's batch-stat BN and so shape the tail frames.  The drain copies
each packed chunk to pinned host memory on a side stream and unpacks it
with numpy while the card computes the next chunk.

``raster_group`` > 0 rasterizes with the grouped kernel K4, whose output
equals the flat kernel's; the streaming driver (``pipeline/streaming.py``)
reuses :meth:`Synthesizer.frame_program_for` and the fetch helpers.

Not ported yet (ROADMAP.md Queue 1): ``SynthesisAssets.from_npz`` /
``from_checkpoints`` / ``from_tf_checkpoints``, the R-Net/detector identity
path, the mp4 mux, multi-device ``mesh`` options.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from voicepuppet_torch.audio.frontend import MelFrontend, full_fp32_matmuls
from voicepuppet_torch.audio.io import load_audio
from voicepuppet_torch.config import Config
from voicepuppet_torch.face3d import bfm as bfm_mod
from voicepuppet_torch.face3d import morph
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.models.bfmnet import BFMNet, init_bfmnet_
from voicepuppet_torch.ops import render_colors_auto
from voicepuppet_torch.pipeline.align import head_sway_angles


@dataclasses.dataclass
class Identity:
    """The 257-dim identity coefficient row, the 224-alignment transform
    and the face crop geometry in the source image."""
    bfmcoeff: np.ndarray          # [1, 257]
    transform_params: np.ndarray  # [w0, h0, 102/s, t0, t1]
    center_x: int
    center_y: int
    ratio: float
    colors_bgr: bool = False


def synthetic_identity(face_model, seed: int = 0,
                       img_size: int = 512) -> Identity:
    """Demo identity: centered face, unit crop ratio."""
    coeff = bfm_mod.demo_coeff(face_model, batch=1, seed=seed)
    return Identity(bfmcoeff=coeff,
                    transform_params=np.array([img_size, img_size, 1.0,
                                               0.0, 0.0]),
                    center_x=img_size // 2, center_y=img_size // 2,
                    ratio=1.0)


def splice_coeff_sequence(identity_coeff: np.ndarray,
                          exp_seq: torch.Tensor) -> torch.Tensor:
    """[1,257] identity + [1,T,64] expressions -> [T,257]
    (id[0:80] | exp | id[144:]; ref: infer_bfmvid.py:223-224)."""
    t = exp_seq.shape[1]
    idc = torch.as_tensor(np.asarray(identity_coeff, np.float32),
                          device=exp_seq.device)
    head = idc[:, None, :80].expand(-1, t, -1)
    tail = idc[:, None, 144:].expand(-1, t, -1)
    return torch.cat([head, exp_seq, tail], dim=-1)[0]


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once (``b`` taken as its float32
    value): the product of two float32 is exact in float64, so one float64
    add and one rounding to float32 give the fused result."""
    return (a.double() * float(np.float32(b)) + c.double()).float()


def _pack_yuv420(frames: torch.Tensor) -> torch.Tensor:
    """[C,S,S,3] float in [0,1] -> [C, S*S*3//2] uint8 planar YUV 4:2:0
    (BT.601 full range, chroma = 2x2 box mean).

    The reference's chained elementwise form, rounded as the reference
    rounds it: XLA fuses each ``a*b + c`` of this chain into one FMA (its
    CPU backend contracts them; measured, tests/test_torch_port_units.py),
    so the products are fused here too, one float32 rounding per FMA, and
    the rounded bytes match it exactly."""
    c, s = frames.shape[0], frames.shape[1]
    f = torch.clamp(frames, 0.0, 1.0) * 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = _fma(b, 0.114, _fma(r, 0.299, g * 0.587))
    u = _fma(b - y, 0.564, torch.full_like(y, 128.0))
    v = _fma(r - y, 0.713, torch.full_like(y, 128.0))

    def box(p):
        q = p.reshape(c, s // 2, 2, s // 2, 2)
        return (((q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0])
                + q[:, :, 1, :, 1]) * 0.25

    packed = torch.cat([y.reshape(c, -1), box(u).reshape(c, -1),
                        box(v).reshape(c, -1)], dim=1)
    return torch.clamp(torch.round(packed), 0, 255).to(torch.uint8)


def _unpack_yuv420(packed: np.ndarray, s: int) -> np.ndarray:
    """Host inverse of :func:`_pack_yuv420`: [N, S*S*3//2] uint8 ->
    [N, S, S, 3] uint8 RGB (nearest chroma upsample; the chroma terms run
    at quarter resolution in int16 1/64 fixed point)."""
    n = packed.shape[0]
    ss = s * s
    y = packed[:, :ss].reshape(n, s, s).astype(np.int16)
    u = packed[:, ss:ss + ss // 4].reshape(n, s // 2, s // 2).astype(
        np.int16) - 128
    v = packed[:, ss + ss // 4:].reshape(n, s // 2, s // 2).astype(
        np.int16) - 128
    rq = (90 * v) >> 6
    gq = (-22 * u - 46 * v) >> 6
    bq = (113 * u) >> 6
    out = np.empty((n, s, s, 3), np.uint8)
    up = np.empty((n, s, s), np.int16)
    for ch, q in ((0, rq), (1, gq), (2, bq)):
        uv = up.reshape(n, s // 2, 2, s // 2, 2)
        uv[:] = q[:, :, None, :, None]
        np.add(up, y, out=up)
        np.clip(up, 0, 255, out=up)
        out[..., ch] = up
    return out


def _paste_geometry(out_hw: int, center_x: int, center_y: int,
                    tx: int, ty: int, img_size: int):
    """Paste window math (ref: infer_bfmvid.py:112-121), clipped to the
    canvas."""
    cf = out_hw // 2
    y0 = center_y - cf - ty
    x0 = center_x - cf - tx
    ty0, tx0 = max(y0, 0), max(x0, 0)
    ty1, tx1 = min(y0 + out_hw, img_size), min(x0 + out_hw, img_size)
    sy0, sx0 = ty0 - y0, tx0 - x0
    sy1, sx1 = sy0 + (ty1 - ty0), sx0 + (tx1 - tx0)
    return (ty0, ty1, tx0, tx1), (sy0, sy1, sx0, sx1)


def resize_linear(face: torch.Tensor, out_hw: int) -> torch.Tensor:
    """NHWC ``jax.image.resize(..., "linear")``: a triangle filter that
    widens (antialiases) when downscaling — torch's bilinear with
    ``antialias=True`` and half-pixel centers."""
    if face.shape[1] == out_hw and face.shape[2] == out_hw:
        return face
    x = F.interpolate(face.permute(0, 3, 1, 2), size=(out_hw, out_hw),
                      mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def tail_bucket(n: int, chunk: int) -> int:
    """Frames rendered for a last chunk of ``n`` < ``chunk`` frames: the
    smallest power of two >= n, floor 8, capped at ``chunk``
    (ref: synthesize.py:440-449)."""
    cc = 8
    while cc < n:
        cc *= 2
    return min(cc, chunk)


class Synthesizer:
    """Weights + programs of the synthesis pipeline on one device.

    ``bfmnet_state`` / ``g_state``: state_dicts of ``BFMNet`` and
    ``PixReferNet`` (``weights.state_dict_from_flax`` makes them from the
    JAX trees; ``SynthesisAssets.init_trees`` makes fresh ones).
    ``gan_dtype``: the generator's conv dtype — bfloat16 serves on the
    card; pass ``torch.float32`` for CPU parity runs.
    ``transfer_format``: only the reference's default, ``"yuv420"``.
    ``raster_group``: > 0 selects the grouped raster kernel K4 (groups of
    that many consecutive triangles), 0 the flat kernel K1; both give the
    same frames."""

    def __init__(self, cfg: Config, face_model,
                 bfmnet_state: Mapping[str, torch.Tensor],
                 g_state: Mapping[str, torch.Tensor],
                 chunk: int = 16, raster_size: int = 224,
                 raster_bb: int = 12, mesh=None,
                 gan_dtype: torch.dtype = torch.bfloat16,
                 transfer_format: str = "yuv420",
                 raster_group: int = 0, device="cuda"):
        if mesh is not None:
            raise NotImplementedError("multi-device mesh serving is not "
                                      "ported yet (ROADMAP.md Queue 1)")
        if transfer_format != "yuv420":
            raise NotImplementedError(
                f"transfer_format {transfer_format!r}: only yuv420 is ported "
                "(ROADMAP.md Queue 1)")
        self.device = torch.device(device)
        full_fp32_matmuls()
        self.cfg = cfg
        self.face_model = face_model
        self.fm = morph.device_bfm(face_model, self.device)
        self.frontend = MelFrontend(cfg.mel, self.device)
        self.bfmnet = BFMNet(cfg.bfmnet)
        self.bfmnet.load_state_dict(bfmnet_state)
        self.bfmnet.to(self.device).eval()
        self.gen = px.PixReferNet(cfg.pixrefer)
        self.gen.load_state_dict(g_state)
        self.gen.set_conv_dtype(gan_dtype).to(self.device).eval()
        self.chunk = chunk
        self.raster_size = raster_size
        self.raster_bb = raster_bb
        self.raster_group = int(raster_group)
        self.img_size = cfg.pixrefer.img_size
        self._side = None         # the d2h copy stream, made at first use

    # ---- program 1: audio -> expression coefficients (whole clip) ----
    @staticmethod
    def _bucket(t: int) -> int:
        """Next power-of-two frame count (>= 16)."""
        b = 16
        while b < t:
            b *= 2
        return b

    @torch.inference_mode()
    def predict_expressions(self, pcm: np.ndarray,
                            rng_seed: int = 0) -> torch.Tensor:
        """pcm [num_samples] -> exp coeffs [1, T, 64].  The clip is padded
        to a bucket length and the result sliced back to T; mel rows past
        T*5 are zeroed at every CNN stage (``mask_time``), so the padding
        does not change frames < T.  The ear signal is the reference's
        random sub-0.01 input (infer_bfmvid.py:182)."""
        cfg = self.cfg
        t = int(1 + pcm.shape[0] / cfg.frame_wav_scale)
        tb = self._bucket(t)
        pcm_len = cfg.pcm_length_for_frames(tb)
        if pcm.shape[0] < pcm_len:
            pcm = np.pad(pcm, (0, pcm_len - pcm.shape[0]))
        pcm = pcm[:pcm_len][None]
        ear = np.zeros((1, tb, 1), np.float32)
        ear[:, :t] = (np.random.RandomState(rng_seed)
                      .rand(1, t, 1).astype(np.float32) / 100.0)
        dev = self.device
        mel = self.frontend(torch.as_tensor(pcm, device=dev))
        exp = self.bfmnet(torch.as_tensor(ear, device=dev), mel,
                          torch.tensor([t], device=dev), mask_time=True)
        return exp[:, :t]

    # ---- program 2: coeffs -> frames (chunked) ----
    def frame_geometry(self, identity: Identity):
        """(out_hw, paste windows, colors_bgr) for an identity."""
        ratio_total = identity.ratio * float(identity.transform_params[2])
        tx = -int(identity.transform_params[3] / ratio_total)
        ty = -int(identity.transform_params[4] / ratio_total)
        out_hw = int(round(self.raster_size / ratio_total))
        paste = _paste_geometry(out_hw, identity.center_x,
                                identity.center_y, tx, ty, self.img_size)
        return out_hw, paste, identity.colors_bgr

    def frame_program_for(self, identity: Identity):
        """The frame program bound to an identity's paste geometry:
        ``(coeff, angles, bg_pool, bg_idx, face3d_ref, fg_ref) -> packed``
        (JAX ``frame_program_for``; nothing is compiled here)."""
        return functools.partial(self.frame_program,
                                 self.frame_geometry(identity))

    def frame_program(self, geometry, coeff, angles, bg_pool, bg_idx,
                      face3d_ref, fg_ref) -> torch.Tensor:
        """One chunk: coeff [C,257], angles [C,3], bg_pool [P,S,S,3],
        bg_idx [C], refs [S,S,3] -> packed uint8 frames."""
        out_hw, paste, colors_bgr = geometry
        (ty0, ty1, tx0, tx1), (sy0, sy1, sx0, sx1) = paste
        rs = self.raster_size
        s = self.img_size
        c = coeff.shape[0]
        background = bg_pool[bg_idx]
        rec = morph.reconstruct_rotation(coeff, self.fm, angles,
                                         image_size=float(rs))
        verts = torch.cat([rec.face_projection, rec.z_buffer],
                          dim=-1).contiguous()
        colors = torch.floor(torch.clamp(rec.face_color, 0.0, 255.0))
        if colors_bgr:
            colors = colors.flip(-1)
        img224, _ = render_colors_auto(verts, colors.contiguous(),
                                       self.fm.tri, h=rs, w=rs,
                                       bb=self.raster_bb,
                                       group=self.raster_group)
        face = resize_linear(img224.float() / 255.0, out_hw)
        canvas = torch.zeros((c, s, s, 3), device=coeff.device)
        canvas[:, ty0:ty1, tx0:tx1] = face[:, sy0:sy1, sx0:sx1]
        ref = face3d_ref[None].expand(c, -1, -1, -1)
        inputs = torch.cat([ref, canvas], dim=-1)
        fg_ref_b = fg_ref[None].expand(c, -1, -1, -1)
        fg_inputs = torch.cat([fg_ref_b, torch.zeros_like(fg_ref_b)], dim=-1)
        outputs, _, _ = self.gen(px.preprocess(inputs),
                                 px.preprocess(fg_inputs),
                                 px.preprocess(background))
        return _pack_yuv420(px.deprocess(outputs))

    @torch.inference_mode()
    def render_frames(self, coeff_seq, identity: Identity,
                      face3d_ref: np.ndarray, fg_ref: np.ndarray,
                      backgrounds, angles: Optional[np.ndarray] = None
                      ) -> np.ndarray:
        """coeff_seq [T,257] -> frames [T,S,S,3] uint8."""
        dev = self.device
        coeff_seq = torch.as_tensor(coeff_seq, dtype=torch.float32,
                                    device=dev)
        t = coeff_seq.shape[0]
        geometry = self.frame_geometry(identity)
        if angles is None:
            angles = head_sway_angles(t)
        angles = torch.as_tensor(np.asarray(angles, np.float32), device=dev)
        face3d_ref = torch.as_tensor(np.asarray(face3d_ref, np.float32),
                                     device=dev)
        fg_ref = torch.as_tensor(np.asarray(fg_ref, np.float32), device=dev)

        # backgrounds -> a device-resident pool + per-frame index
        if isinstance(backgrounds, np.ndarray):
            pool = backgrounds.reshape((-1,) + backgrounds.shape[-3:])
            bg_idx_all = np.arange(t) % pool.shape[0]
        else:
            seen = []
            bg_idx_all = np.zeros((t,), np.int64)
            for i in range(t):
                bg = next(backgrounds)
                for j, s_ in enumerate(seen):
                    if s_ is bg:
                        bg_idx_all[i] = j
                        break
                else:
                    seen.append(bg)
                    bg_idx_all[i] = len(seen) - 1
            pool = np.stack(seen)
        bg_pool = torch.as_tensor(np.asarray(pool, np.float32), device=dev)
        bg_idx_all = torch.as_tensor(bg_idx_all, dtype=torch.int64,
                                     device=dev)

        frames = np.zeros((t, self.img_size, self.img_size, 3), np.uint8)
        c = self.chunk
        pending = collections.deque()

        def drain():
            start, n, fetch = pending.popleft()
            frames[start:start + n] = self.finish_fetch(fetch, n)

        for start in range(0, t, c):
            n = min(c, t - start)
            cc = c if n == c else tail_bucket(n, c)
            coeff_c = torch.zeros((cc, 257), device=dev)
            coeff_c[:n] = coeff_seq[start:start + n]
            ang_c = torch.zeros((cc, 3), device=dev)
            ang_c[:n] = angles[start:start + n]
            idx_c = torch.zeros((cc,), dtype=torch.int64, device=dev)
            idx_c[:n] = bg_idx_all[start:start + n]
            out = self.frame_program(geometry, coeff_c, ang_c, bg_pool,
                                     idx_c, face3d_ref, fg_ref)
            pending.append((start, n, self.start_fetch(out)))
            while len(pending) > 2:
                drain()
        while pending:
            drain()
        return frames

    def start_fetch(self, out: torch.Tensor):
        """Start the device-to-host copy of a packed chunk; returns the
        handle :meth:`finish_fetch` takes.  On a CUDA device the copy runs
        into pinned memory on a side stream, so chunk k's copy overlaps
        chunk k+1's compute."""
        if out.device.type != "cuda":
            return out, None
        if self._side is None:
            self._side = torch.cuda.Stream(out.device)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self._side.wait_stream(torch.cuda.current_stream(out.device))
        with torch.cuda.stream(self._side):
            host.copy_(out, non_blocking=True)
        out.record_stream(self._side)
        done = torch.cuda.Event()
        done.record(self._side)
        return host, done

    def finish_fetch(self, fetch, n: int) -> np.ndarray:
        """Wait for a :meth:`start_fetch` copy -> [n,S,S,3] uint8 RGB."""
        host, done = fetch
        if done is not None:
            done.synchronize()
        return self.fetch_frames(host.numpy(), n)

    def fetch_frames(self, packed: np.ndarray, n: int) -> np.ndarray:
        """Host chunk of packed YUV 4:2:0 -> [n,S,S,3] uint8 RGB."""
        return _unpack_yuv420(packed[:n], self.img_size)

    # ---- the full contract ----
    def synthesize(self, image_path_or_panel, audio_path_or_pcm,
                   identity: Identity,
                   backgrounds: Optional[Iterator[np.ndarray]] = None
                   ) -> np.ndarray:
        """image (S x 3S panel: img | render | alpha) + audio -> frames
        [T,S,S,3] uint8."""
        s = self.img_size
        if isinstance(image_path_or_panel, str):
            from voicepuppet_torch.data.loaders import load_image
            panel = load_image(image_path_or_panel)
        else:
            panel = np.asarray(image_path_or_panel, np.float32)
        face3d_ref = panel[:, s:2 * s, :]
        fg_ref = panel[:, :s, :] * (panel[:, 2 * s:, :]
                                    if panel.shape[1] >= 3 * s
                                    else np.ones_like(panel[:, :s, :]))
        if isinstance(audio_path_or_pcm, str):
            pcm = load_audio(audio_path_or_pcm, self.cfg.mel.sample_rate)
        else:
            pcm = np.asarray(audio_path_or_pcm, np.float32)
        exp = self.predict_expressions(pcm)
        coeff_seq = splice_coeff_sequence(identity.bfmcoeff, exp)
        if backgrounds is None:
            backgrounds = constant_background(np.zeros((s, s, 3),
                                                        np.float32))
        return self.render_frames(coeff_seq, identity, face3d_ref, fg_ref,
                                  backgrounds)


def constant_background(bg: np.ndarray) -> Iterator[np.ndarray]:
    while True:
        yield bg


def cycling_backgrounds(directory: str, img_size: int,
                        count: int = 100) -> Iterator[np.ndarray]:
    """background/1.jpg..100.jpg cycled per frame (infer_bfmvid.py:238);
    a missing file is a black frame."""
    from voicepuppet_torch.data.loaders import load_image
    cache: Dict[int, np.ndarray] = {}
    i = 0
    while True:
        idx = i % count + 1
        if idx not in cache:
            path = os.path.join(directory, f"{idx}.jpg")
            cache[idx] = (load_image(path, resize=(img_size, img_size))
                          if os.path.exists(path)
                          else np.zeros((img_size, img_size, 3),
                                        np.float32))
        yield cache[idx]
        i += 1


class SynthesisAssets:
    """Builds a Synthesizer from fresh random weights (the demo path)."""

    @staticmethod
    def init_trees(cfg: Config, seed: int = 0
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Fresh (bfmnet_state, g_state) at the configured sizes, drawn on
        the CPU from ``torch.Generator().manual_seed(seed)``."""
        g = torch.Generator().manual_seed(seed)
        bfm = init_bfmnet_(BFMNet(cfg.bfmnet), g)
        gen = px.init_pixrefer_(px.PixReferNet(cfg.pixrefer), g)
        return bfm.state_dict(), gen.state_dict()

    @staticmethod
    def demo(cfg: Config, seed: int = 0, face_model=None,
             **synth_kwargs) -> Tuple[Synthesizer, Identity]:
        face_model = face_model or bfm_mod.synthetic_bfm(num_theta=48,
                                                         num_phi=48)
        bfm_state, g_state = SynthesisAssets.init_trees(cfg, seed)
        synth = Synthesizer(cfg, face_model, bfm_state, g_state,
                            **synth_kwargs)
        return synth, synthetic_identity(face_model, seed,
                                         cfg.pixrefer.img_size)


def write_frames(frames: np.ndarray, out_dir: str):
    """PNG sequence ``0.png ..`` (the mp4 mux is not ported yet)."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    for i in range(frames.shape[0]):
        Image.fromarray(frames[i]).save(os.path.join(out_dir, f"{i}.png"))


def main(argv=None):
    """Demo-path CLI: ``python -m voicepuppet_torch.pipeline.synthesize
    [--config_path cfg.yml] [--out_dir output] [--background_dir dir]
    [--device cuda] image audio`` — random weights, synthetic BFM."""
    import argparse
    from voicepuppet_torch.config import load_config

    p = argparse.ArgumentParser()
    p.add_argument("--config_path", default=None)
    p.add_argument("--out_dir", default="output")
    p.add_argument("--background_dir", default="background")
    p.add_argument("--device", default="cuda")
    p.add_argument("image")
    p.add_argument("audio")
    args = p.parse_args(argv)
    cfg = load_config(args.config_path)
    synth, identity = SynthesisAssets.demo(cfg, device=args.device)
    bgs = cycling_backgrounds(args.background_dir, cfg.pixrefer.img_size)
    frames = synth.synthesize(args.image, args.audio, identity,
                              backgrounds=bgs)
    write_frames(frames, args.out_dir)
    print(f"wrote {frames.shape[0]} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
