"""End-to-end synthesis: one face panel + audio -> video frames.

Port of the serving path of ``voicepuppet_tpu/pipeline/synthesize.py``:

    pcm -> MelFrontend -> BFMNet (bucketed, mask_time) -> coeff splice ->
    3DMM decode (reconstruct_rotation) -> flat z-buffer raster @224²
    (ops.render_colors_auto: the CUDA kernel) -> resize/paste ->
    PixRefer G @512² (per-chunk batch-stat BN) -> composite ->
    YUV 4:2:0 pack (or rgb8) -> chunked drain + host unpack

Frames are rendered in chunks of ``chunk``; the last chunk pads to the
smallest power of two >= its length (floor 8, cap ``chunk``), exactly as
the reference does, because the padded zero-coefficient frames enter the
generator's batch-stat BN and so shape the tail frames (``_tail_bucket``
False pads it to the whole chunk, an A/B switch of
``experiments/profile_tail_bucket.py``).  The drain copies
each packed chunk to pinned host memory on a side stream; a persistent
pool of ``drain_workers`` threads waits for each copy and unpacks it with
numpy while the card computes the next chunks (pipeline depth 4, each task
writing its own frame slice).

Weights come from fresh random draws (``SynthesisAssets.demo``), from the
port's own training checkpoints (``from_checkpoints``), from the
reference's TF checkpoints (``from_tf_checkpoints``) or from TF-named npz
dumps (``from_npz``), read with no TensorFlow by ``tools/``.

``raster_group`` > 0 rasterizes with the grouped kernel K4, whose output
equals the flat kernel's; the streaming driver (``pipeline/streaming.py``)
reuses :meth:`Synthesizer.frame_program_for` and the fetch helpers.

Sharded serving (``mesh=``, a ``parallel.mesh.DataGroup`` of several
ranks, each a process with its own device): every rank builds the same
Synthesizer and calls ``render_frames`` / ``synthesize`` (or feeds a
``StreamingSynthesizer``) with the same arguments, SPMD, as the trainers'
steps are called.  Every rank runs the coefficient program, which is
replicated.  ``mesh_partition="frames"`` splits each chunk's frames over
the ranks: the chunk is rounded down to a multiple of the world size
(at least the world size) and so is a tail bucket; each rank decodes,
rasterizes (K1) and packs its rows, the generator's batch-stat BN taking
its moments over the whole chunk (``layers.sync_bn``), and rank 0
gathers the packed chunk in frame order.  ``"spatial"`` keeps the frames
whole on every rank (decode and K1 over the whole chunk) and splits the
generator's height (``parallel/spatial.py``: conv halo exchanges); each
rank packs its band of rows and rank 0 gathers the bands.  That scales one frame's latency, the
mode for streaming.  Rank 0 drains and returns the frames; the other
ranks return None (``StreamingSynthesizer`` yields no blocks there).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from voicepuppet_torch.audio.frontend import MelFrontend, full_fp32_matmuls
from voicepuppet_torch.audio.io import load_audio
from voicepuppet_torch.config import Config
from voicepuppet_torch.face3d import bfm as bfm_mod
from voicepuppet_torch.face3d import morph
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.models.bfmnet import BFMNet, init_bfmnet_
from voicepuppet_torch.models.layers import sync_bn
from voicepuppet_torch.ops import render_colors_auto
from voicepuppet_torch.parallel import spatial
from voicepuppet_torch.parallel.mesh import (gather_to_main, rank_rows,
                                             replicate)
from voicepuppet_torch.pipeline.align import head_sway_angles
from voicepuppet_torch.tools import tf_checkpoint as tfc
from voicepuppet_torch.tools.tf_bundle import read_checkpoint
from voicepuppet_torch.weights import check_state_dict

TRANSFER_FORMATS = ("yuv420", "rgb8")
MESH_PARTITIONS = ("frames", "spatial")
DRAIN_DEPTH = 4         # chunks in flight between dispatch and drain


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
    """[C,H,W,3] float in [0,1] -> [C, H*W*3//2] uint8 planar YUV 4:2:0
    (BT.601 full range, chroma = 2x2 box mean; H and W even).

    The reference's chained elementwise form, rounded as the reference
    rounds it: XLA fuses each ``a*b + c`` of this chain into one FMA (its
    CPU backend contracts them; measured, tests/test_torch_port_units.py),
    so the products are fused here too, one float32 rounding per FMA, and
    the rounded bytes match it exactly."""
    c, h, w = frames.shape[:3]
    f = torch.clamp(frames, 0.0, 1.0) * 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = _fma(b, 0.114, _fma(r, 0.299, g * 0.587))
    u = _fma(b - y, 0.564, torch.full_like(y, 128.0))
    v = _fma(r - y, 0.713, torch.full_like(y, 128.0))

    def box(p):
        q = p.reshape(c, h // 2, 2, w // 2, 2)
        return (((q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0])
                + q[:, :, 1, :, 1]) * 0.25

    packed = torch.cat([y.reshape(c, -1), box(u).reshape(c, -1),
                        box(v).reshape(c, -1)], dim=1)
    return torch.clamp(torch.round(packed), 0, 255).to(torch.uint8)


def pack_frames(frames: torch.Tensor, transfer_format: str) -> torch.Tensor:
    """[C,H,W,3] float frames in [0,1], or an even band of their rows
    (:func:`join_packed_rows`), packed for the drain."""
    if transfer_format == "yuv420":
        return _pack_yuv420(frames)
    return torch.clamp(frames * 255.0, 0, 255).to(torch.uint8)


def join_packed_rows(parts, transfer_format: str) -> torch.Tensor:
    """The packed chunk from the packed bands of its rows, top to bottom
    (each band an even number of rows): rgb8 bands stack on the rows,
    yuv420 bands plane by plane.  Each packed byte depends on its own
    pixel (rgb8) or 2x2 block (yuv420) only, so the result is the packed
    whole chunk, byte for byte."""
    if transfer_format == "rgb8":
        return torch.cat(parts, 1)
    band = parts[0].shape[1] * 2 // 3       # Y bytes of one band
    planes = [p.split([band, band // 4, band // 4], 1) for p in parts]
    return torch.cat([torch.cat([p[i] for p in planes], 1)
                      for i in range(3)], 1)


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


def frames_chunk(chunk: int, world: int) -> int:
    """The chunk of a ``frames`` partition over ``world`` ranks: rounded
    DOWN to a multiple of the world size, at least the world size
    (ref: synthesize.py:210-212)."""
    c = max(chunk, world)
    return c - c % world


def tail_bucket(n: int, chunk: int, multiple: int = 1) -> int:
    """Frames rendered for a last chunk of ``n`` < ``chunk`` frames: the
    smallest power of two >= n, floor 8, then at least ``multiple`` and
    rounded up to a multiple of it (the ranks of a ``frames`` partition),
    capped at ``chunk`` (ref: synthesize.py:440-449)."""
    cc = 8
    while cc < n:
        cc *= 2
    cc = max(cc, multiple)
    cc += -cc % multiple
    return min(cc, chunk)


class Synthesizer:
    """Weights + programs of the synthesis pipeline on one device.

    ``bfmnet_state`` / ``g_state``: state_dicts of ``BFMNet`` and
    ``PixReferNet`` (``weights.state_dict_from_flax`` makes them from the
    JAX trees; ``SynthesisAssets.init_trees`` makes fresh ones).
    ``gan_dtype``: the generator's conv dtype — bfloat16 serves on the
    card; pass ``torch.float32`` for CPU parity runs.
    ``bfmnet_dtype``: the BFMNet conv trunk's compute dtype (its GRU and
    head stay float32); bfloat16 moves the coefficients by ~1e-3.
    ``transfer_format``: ``"yuv420"`` (default, 1.5 B/px) or ``"rgb8"``
    (3 B/px, no host unpack); the frames come back as RGB uint8 either way.
    ``drain_workers``: threads that wait for and unpack drained chunks.
    ``raster_group``: > 0 selects the grouped raster kernel K4 (groups of
    that many consecutive triangles), 0 the flat kernel K1; both give the
    same frames.
    ``mesh``: a ``parallel.mesh.DataGroup`` (``make_mesh()`` under
    torchrun, or a ``parallel.spawn.run_ranks`` group); the device is then
    the rank's.  Over several ranks the calls are SPMD (module docstring)
    and the weights are broadcast from rank 0; a group of one rank serves
    as no mesh does.  A mesh of several ranks with no initialized process
    group raises.
    ``mesh_partition``: ``"frames"`` (default; ``chunk`` is rounded down
    to a multiple of the world size) or ``"spatial"`` (``chunk`` as
    given; the image size must split, ``spatial.split_level``)."""

    def __init__(self, cfg: Config, face_model,
                 bfmnet_state: Mapping[str, torch.Tensor],
                 g_state: Mapping[str, torch.Tensor],
                 chunk: int = 16, raster_size: int = 224,
                 raster_bb: int = 12, mesh=None,
                 mesh_partition: str = "frames",
                 gan_dtype: torch.dtype = torch.bfloat16,
                 bfmnet_dtype: torch.dtype = torch.float32,
                 transfer_format: str = "yuv420",
                 drain_workers: int = 1,
                 raster_group: int = 0, device="cuda"):
        self._drain_pool = None
        if mesh_partition not in MESH_PARTITIONS:
            raise ValueError(f"mesh_partition {mesh_partition!r}: one of "
                             f"{MESH_PARTITIONS}")
        if transfer_format not in TRANSFER_FORMATS:
            raise NotImplementedError(
                f"transfer_format {transfer_format!r}: only "
                f"{' and '.join(TRANSFER_FORMATS)} are ported")
        self.mesh = mesh
        self.mesh_partition = mesh_partition
        # the partition actually served: None for one process
        self._partition = None
        if mesh is not None and mesh.world > 1:
            if mesh.group is None or not dist.is_initialized():
                raise RuntimeError(
                    f"a {mesh.world}-rank mesh with no initialized process "
                    f"group: start the group (torchrun + make_mesh(), or "
                    f"run_ranks) before serving sharded")
            self._partition = mesh_partition
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        full_fp32_matmuls()
        self.cfg = cfg
        self.face_model = face_model
        self.fm = morph.device_bfm(face_model, self.device)
        self.frontend = MelFrontend(cfg.mel, self.device)
        self.bfmnet = BFMNet(cfg.bfmnet, dtype=bfmnet_dtype)
        self.bfmnet.load_state_dict(bfmnet_state)
        self.bfmnet.to(self.device).eval()
        self.gen = px.PixReferNet(cfg.pixrefer)
        self.gen.load_state_dict(g_state)
        self.gen.set_conv_dtype(gan_dtype).to(self.device).eval()
        self.img_size = cfg.pixrefer.img_size
        if self._partition is not None:
            replicate([self.bfmnet, self.gen], mesh)
        if self._partition == "frames":
            chunk = frames_chunk(chunk, mesh.world)
        if (self._partition == "spatial"
                and not spatial.split_level(self.img_size, mesh.world)):
            raise ValueError(f"mesh_partition 'spatial': {self.img_size} "
                             f"rows do not split over {mesh.world} ranks")
        self.chunk = chunk
        # tail bucketing in render_frames (the A/B switch of
        # experiments/profile_tail_bucket.py; always on in serving)
        self._tail_bucket = True
        self.raster_size = raster_size
        self.raster_bb = raster_bb
        self.raster_group = int(raster_group)
        self.transfer_format = transfer_format
        self.drain_workers = max(1, int(drain_workers))
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

    @property
    def is_main(self) -> bool:
        """Rank 0 of a mesh, or a process serving alone: the caller that
        gets the frames."""
        return self._partition is None or self.mesh.is_main

    def frame_program(self, geometry, coeff, angles, bg_pool, bg_idx,
                      face3d_ref, fg_ref) -> Optional[torch.Tensor]:
        """One chunk: coeff [C,257], angles [C,3], bg_pool [P,S,S,3],
        bg_idx [C], refs [S,S,3] -> packed uint8 frames.  Sharded, every
        rank passes the whole chunk; rank 0 gets the packed chunk and the
        other ranks None."""
        part = self._partition
        group = None if part is None else self.mesh.group
        if part == "frames":
            coeff, angles, bg_idx = rank_rows((coeff, angles, bg_idx),
                                              self.mesh)
        inputs, fg_inputs, background = self._generator_inputs(
            geometry, coeff, angles, bg_pool, bg_idx, face3d_ref, fg_ref)
        if part == "spatial":
            rows = spatial.RowSplit(group)
            raw = spatial.generator_rows(self.gen.generator, inputs,
                                         fg_inputs[..., :3], group)
            outputs, _, _ = px.composite(raw, rows.take(background, 1))
        else:
            with sync_bn(group, self.gen):
                outputs, _, _ = self.gen(inputs, fg_inputs, background)
        packed = pack_frames(px.deprocess(outputs), self.transfer_format)
        if part is None:
            return packed
        parts = gather_to_main(packed, self.mesh)
        if parts is None:
            return None
        return (torch.cat(parts) if part == "frames"
                else join_packed_rows(parts, self.transfer_format))

    def _generator_inputs(self, geometry, coeff, angles, bg_pool, bg_idx,
                          face3d_ref, fg_ref):
        """3DMM decode, K1 raster, resize and paste -> the generator's
        (inputs, fg_inputs, targets), NHWC in [-1, 1]."""
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
        return (px.preprocess(inputs), px.preprocess(fg_inputs),
                px.preprocess(background))

    @torch.inference_mode()
    def render_frames(self, coeff_seq, identity: Identity,
                      face3d_ref: np.ndarray, fg_ref: np.ndarray,
                      backgrounds, angles: Optional[np.ndarray] = None
                      ) -> Optional[np.ndarray]:
        """coeff_seq [T,257] -> frames [T,S,S,3] uint8 (None on a rank
        other than 0 of a sharded Synthesizer)."""
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
        multiple = self.mesh.world if self._partition == "frames" else 1

        def drain(start, n, fetch):
            frames[start:start + n] = self.finish_fetch(fetch, n)

        pool = self._drain_executor()
        futures = []
        for start in range(0, t, c):
            n = min(c, t - start)
            cc = (tail_bucket(n, c, multiple)
                  if n < c and self._tail_bucket else c)
            coeff_c = torch.zeros((cc, 257), device=dev)
            coeff_c[:n] = coeff_seq[start:start + n]
            ang_c = torch.zeros((cc, 3), device=dev)
            ang_c[:n] = angles[start:start + n]
            idx_c = torch.zeros((cc,), dtype=torch.int64, device=dev)
            idx_c[:n] = bg_idx_all[start:start + n]
            out = self.frame_program(geometry, coeff_c, ang_c, bg_pool,
                                     idx_c, face3d_ref, fg_ref)
            if out is None:
                continue
            fetch = self.start_fetch(out)
            while len(futures) >= DRAIN_DEPTH:
                futures.pop(0).result()
            futures.append(pool.submit(drain, start, n, fetch))
        for f in futures:
            f.result()
        return frames if self.is_main else None

    def _drain_executor(self) -> ThreadPoolExecutor:
        """The drain pool, made at first use; it persists across calls (a
        streaming caller renders one block per call)."""
        if self._drain_pool is None:
            self._drain_pool = ThreadPoolExecutor(
                max_workers=self.drain_workers,
                thread_name_prefix="synth-drain")
        return self._drain_pool

    def close(self):
        if self._drain_pool is not None:
            self._drain_pool.shutdown(wait=False)
            self._drain_pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

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
        """A whole host chunk (packed YUV 4:2:0 or rgb8), sliced on the host
        -> [n,S,S,3] uint8 RGB."""
        if self.transfer_format == "yuv420":
            return _unpack_yuv420(packed[:n], self.img_size)
        return packed[:n]

    @torch.inference_mode()
    def estimate_chunk_compute(self, identity: Identity, k: int = 8,
                               repeats: int = 3) -> float:
        """Seconds of compute per ``chunk``-frame chunk: ``k`` frame
        programs back to back, each fed a coefficient that depends on the
        previous packed output, timed against one, ``(t_k - t_1)/(k - 1)``
        with the minimum of each over ``repeats``.  CUDA events time it on
        the card (no host round trip inside), ``perf_counter`` on the CPU.
        NaN where t_k <= t_1: noise swamped the measurement, and no rate is
        made up."""
        prog = self.frame_program_for(identity)
        dev = self.device
        c, s = self.chunk, self.img_size
        ang = torch.zeros((c, 3), device=dev)
        bg_pool = torch.zeros((1, s, s, 3), device=dev)
        idx = torch.zeros((c,), dtype=torch.int64, device=dev)
        ref = torch.zeros((s, s, 3), device=dev)
        cuda = dev.type == "cuda"

        def run(n):
            coeff = torch.zeros((c, 257), device=dev)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                t0 = time.perf_counter()
            for _ in range(n):
                out = prog(coeff, ang, bg_pool, idx, ref, ref)
                if out is not None:
                    coeff = coeff + 1e-30 * out.reshape(-1)[0].float()
            if cuda:
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
            return time.perf_counter() - t0

        run(1)
        run(k)
        t1 = tk = float("inf")
        for _ in range(repeats):
            t1 = min(t1, run(1))
            tk = min(tk, run(k))
        if tk <= t1:
            return float("nan")
        return (tk - t1) / (k - 1)

    # ---- the full contract ----
    def synthesize(self, image_path_or_panel, audio_path_or_pcm,
                   identity: Identity,
                   backgrounds: Optional[Iterator[np.ndarray]] = None,
                   out_dir: Optional[str] = None,
                   audio_path_for_mux: Optional[str] = None) -> np.ndarray:
        """image (S x 3S panel: img | render | alpha) + audio -> frames
        [T,S,S,3] uint8; with ``out_dir``, also PNGs and, where ffmpeg is on
        PATH, an ``output.mp4`` muxed with the audio file."""
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
            audio_path_for_mux = audio_path_for_mux or audio_path_or_pcm
        else:
            pcm = np.asarray(audio_path_or_pcm, np.float32)
        exp = self.predict_expressions(pcm)
        coeff_seq = splice_coeff_sequence(identity.bfmcoeff, exp)
        if backgrounds is None:
            backgrounds = constant_background(np.zeros((s, s, 3),
                                                        np.float32))
        frames = self.render_frames(coeff_seq, identity, face3d_ref, fg_ref,
                                    backgrounds)
        if out_dir is not None:
            write_frames_and_mux(frames, out_dir, audio_path_for_mux,
                                 self.cfg.frame_rate)
        return frames


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


def _module_state(make) -> Dict[str, torch.Tensor]:
    """The state_dict of ``make()`` built on the meta device: its keys and
    shapes, with no weights allocated."""
    with torch.device("meta"):
        return make().state_dict()


class SynthesisAssets:
    """Builds a Synthesizer from fresh random weights (the demo path), from
    the trainers' checkpoint directories, from the reference's TF
    checkpoints, or from TF-named npz dumps."""

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
    def states_from_arrays(cfg: Config, bfmnet_arrays, pixrefer_arrays,
                           bfmnet_what: str, pixrefer_what: str
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Dict[str, torch.Tensor]]:
        """TF-named arrays -> complete (bfmnet_state, g_state), or a
        ``ValueError`` naming the first three missing, unexpected or
        mis-shaped variables of either."""
        bfm_own = _module_state(lambda: BFMNet(cfg.bfmnet))
        g_own = _module_state(lambda: px.PixReferNet(cfg.pixrefer))
        return (tfc.strict_state(bfmnet_arrays, bfm_own,
                                 tfc.bfmnet_rows(bfm_own), bfmnet_what),
                tfc.strict_state(pixrefer_arrays, g_own,
                                 tfc.pixrefer_generator_name_map(),
                                 pixrefer_what))

    @staticmethod
    def load_npz_weights(cfg: Config, bfmnet_npz: str, pixrefer_g_npz: str
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
        """TF-named npz dumps (``bfmnet.npz`` / ``pixrefer_g.npz``) ->
        (bfmnet_state, g_state)."""
        return SynthesisAssets.states_from_arrays(
            cfg, tfc.read_npz(bfmnet_npz), tfc.read_npz(pixrefer_g_npz),
            f"bfmnet npz {bfmnet_npz}", f"pixrefer npz {pixrefer_g_npz}")

    @staticmethod
    def load_tf_weights(cfg: Config, bfmnet_prefix: str,
                        pixrefer_prefix: str
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
        """The reference's TF checkpoints (``ckpt_bfmnet/bfmnet-65000``,
        ``ckpt_pixrefer/pixrefernet-20000``: V2 bundles or V1 files) ->
        (bfmnet_state, g_state), read with no TensorFlow.  Variables no
        row names (the discriminator, optimizer slots) are ignored."""
        return SynthesisAssets.states_from_arrays(
            cfg, read_checkpoint(bfmnet_prefix),
            read_checkpoint(pixrefer_prefix),
            f"bfmnet ckpt {bfmnet_prefix}",
            f"pixrefer ckpt {pixrefer_prefix}")

    @staticmethod
    def from_npz(cfg: Config, bfmnet_npz: str, pixrefer_g_npz: str,
                 face_model=None, mesh=None, **synth_kwargs) -> Synthesizer:
        face_model = face_model or bfm_mod.synthetic_bfm(num_theta=48,
                                                         num_phi=48)
        return Synthesizer(cfg, face_model,
                           *SynthesisAssets.load_npz_weights(
                               cfg, bfmnet_npz, pixrefer_g_npz),
                           mesh=mesh, **synth_kwargs)

    @staticmethod
    def load_checkpoint_weights(cfg: Config, bfmnet_ckpt_dir: str,
                                pixrefer_ckpt_dir: str
                                ) -> Tuple[Dict[str, torch.Tensor],
                                           Dict[str, torch.Tensor]]:
        """The latest checkpoints of the two trainers
        (``train/checkpoint.py``) -> (bfmnet_state, g_state): BFMNet's
        parameters and running BN moments, the generator's parameters.
        A directory with no checkpoint, or a state that does not match
        ``cfg``'s modules, raises."""
        from voicepuppet_torch.train.checkpoint import CheckpointManager
        states = []
        for directory, key, make in (
                (bfmnet_ckpt_dir, "model", lambda: BFMNet(cfg.bfmnet)),
                (pixrefer_ckpt_dir, "gen",
                 lambda: px.PixReferNet(cfg.pixrefer))):
            blob = CheckpointManager(directory).load()
            if blob is None:
                raise FileNotFoundError(f"no checkpoint in {directory}")
            check_state_dict(_module_state(make), blob[key],
                             f"checkpoint {directory}")
            states.append(blob[key])
        return states[0], states[1]

    @staticmethod
    def from_checkpoints(cfg: Config, bfmnet_ckpt_dir: str,
                         pixrefer_ckpt_dir: str, face_model=None,
                         mesh=None, **synth_kwargs) -> Synthesizer:
        """Compose the two trained models from the trainers' checkpoint
        directories (the reference restores two scoped checkpoints into
        one graph; infer_bfmvid.py:207-218)."""
        face_model = face_model or bfm_mod.synthetic_bfm(num_theta=48,
                                                         num_phi=48)
        return Synthesizer(cfg, face_model,
                           *SynthesisAssets.load_checkpoint_weights(
                               cfg, bfmnet_ckpt_dir, pixrefer_ckpt_dir),
                           mesh=mesh, **synth_kwargs)

    @staticmethod
    def from_tf_checkpoints(cfg: Config, bfmnet_prefix: str,
                            pixrefer_prefix: str, face_model=None,
                            mesh=None, **synth_kwargs) -> Synthesizer:
        face_model = face_model or bfm_mod.synthetic_bfm(num_theta=48,
                                                         num_phi=48)
        return Synthesizer(cfg, face_model,
                           *SynthesisAssets.load_tf_weights(
                               cfg, bfmnet_prefix, pixrefer_prefix),
                           mesh=mesh, **synth_kwargs)

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


def write_frames_and_mux(frames: np.ndarray, out_dir: str,
                         audio_path: Optional[str], frame_rate: int):
    """PNG sequence ``0.png ..`` and, when an audio path is given and ffmpeg
    is on PATH, ``output.mp4`` (H.264 yuv420p + AAC; ref:
    infer_bfmvid.py:243-246)."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    for i in range(frames.shape[0]):
        Image.fromarray(frames[i]).save(os.path.join(out_dir, f"{i}.png"))
    ffmpeg = shutil.which("ffmpeg")
    if audio_path is not None and ffmpeg is not None:
        subprocess.run([ffmpeg, "-v", "error", "-framerate", str(frame_rate),
                        "-i", os.path.join(out_dir, "%d.png"), "-i",
                        audio_path, "-c:v", "libx264", "-pix_fmt", "yuv420p",
                        "-c:a", "aac", "-shortest", "-y",
                        os.path.join(out_dir, "output.mp4")], check=False)


def _resolve_face_model(cfg: Config):
    """The BFM of ``cfg.model_dir`` when it holds ``BFM_model_front.mat``,
    else the synthetic stand-in."""
    if os.path.exists(os.path.join(cfg.model_dir, "BFM_model_front.mat")):
        return bfm_mod.load_bfm(cfg.model_dir)
    return bfm_mod.synthetic_bfm(num_theta=48, num_phi=48)


def load_identity_npz(path: str) -> Identity:
    """An identity npz (bfmcoeff, transform_params, center_x, center_y,
    ratio and optionally colors_bgr, default True: R-Net coefficients)."""
    blob = np.load(path)
    return Identity(bfmcoeff=blob["bfmcoeff"],
                    transform_params=blob["transform_params"],
                    center_x=int(blob["center_x"]),
                    center_y=int(blob["center_y"]),
                    ratio=float(blob["ratio"]),
                    colors_bgr=bool(blob.get("colors_bgr", True)))


def photo_identity(cfg: Config, image_path: str, landmark_model: str,
                   rnet_npz: Optional[str] = None,
                   rnet_pb: Optional[str] = None,
                   device="cuda") -> Identity:
    """The reference's novel-face path (infer_bfmvid.py:170-173): 68
    landmarks from a TorchScript detector -> SAT crop geometry -> R-Net
    identity coefficients, all on ``device``."""
    from voicepuppet_torch.data.loaders import load_image
    from voicepuppet_torch.pipeline.detect import (
        TorchScriptLandmarkProvider, sat_alignment)
    from voicepuppet_torch.pipeline.rnet import RNetIdentityProvider
    from voicepuppet_torch.tools.bfm_tools import resolve_lm3d

    src = load_image(image_path)[:, :cfg.pixrefer.img_size, :]
    out = sat_alignment(src, TorchScriptLandmarkProvider(landmark_model,
                                                         device=device))
    if out is None:
        raise SystemExit("no face detected by --landmark_model")
    _, _, img_cropped, lmk_c, cx, cy, ratio = out
    lm3d = resolve_lm3d(cfg.model_dir)
    provider = (RNetIdentityProvider.from_pb(rnet_pb, lm3d, device=device)
                if rnet_pb else
                RNetIdentityProvider.from_npz(rnet_npz, lm3d, device=device))
    return provider(img_cropped, lmk_c, cx, cy, ratio)


def main(argv=None):
    """CLI of the reference script (``infer_bfmvid.py --config_path cfg.yml
    image audio``): ``python -m voicepuppet_torch.pipeline.synthesize
    [--config_path cfg.yml] [--out_dir output] [--background_dir dir]
    [--bfmnet_ckpt D --pixrefer_ckpt D | --bfmnet_tf_ckpt P
    --pixrefer_tf_ckpt P | --bfmnet_npz F --pixrefer_npz F]
    [--identity_npz F | --landmark_model F --rnet_npz F
    | --rnet_pb F] [--device cuda] image audio``.  With no weight flags it
    serves random weights; with no identity flags, the synthetic one."""
    import argparse
    from voicepuppet_torch.config import load_config

    p = argparse.ArgumentParser()
    p.add_argument("--config_path", default=None)
    p.add_argument("--out_dir", default="output")
    p.add_argument("--background_dir", default="background")
    p.add_argument("--device", default="cuda")
    p.add_argument("--bfmnet_ckpt", default=None,
                   help="checkpoint directory of the BFMNet trainer")
    p.add_argument("--pixrefer_ckpt", default=None,
                   help="checkpoint directory of the PixRefer trainer")
    p.add_argument("--bfmnet_tf_ckpt", default=None,
                   help="reference TF checkpoint prefix (e.g. "
                        "ckpt_bfmnet/bfmnet-65000), read with no TF")
    p.add_argument("--pixrefer_tf_ckpt", default=None,
                   help="reference TF checkpoint prefix (e.g. "
                        "ckpt_pixrefer/pixrefernet-20000), read with no TF")
    p.add_argument("--bfmnet_npz", default=None,
                   help="TF-named bfmnet.npz")
    p.add_argument("--pixrefer_npz", default=None,
                   help="TF-named pixrefer_g.npz")
    p.add_argument("--identity_npz", default=None,
                   help="npz with bfmcoeff/transform_params/center_x/"
                        "center_y/ratio (replaces the detector and R-Net)")
    p.add_argument("--landmark_model", default=None,
                   help="TorchScript 68-landmark detector; with --rnet_npz "
                        "or --rnet_pb the face photo's identity path")
    p.add_argument("--rnet_npz", default=None,
                   help="slim-named npz of the Deep3DFace R-Net")
    p.add_argument("--rnet_pb", default=None,
                   help="the reference's FaceReconModel.pb, read with no TF")
    p.add_argument("image")
    p.add_argument("audio")
    args = p.parse_args(argv)

    cfg = load_config(args.config_path)
    sources = (args.bfmnet_ckpt, args.bfmnet_tf_ckpt, args.bfmnet_npz)
    if sum(b is not None for b in sources) > 1:
        p.error("--bfmnet_ckpt, --bfmnet_tf_ckpt and --bfmnet_npz: give "
                "one weight source, not several")
    if (args.bfmnet_ckpt is None) != (args.pixrefer_ckpt is None):
        p.error("--bfmnet_ckpt and --pixrefer_ckpt must be given together")
    if (args.bfmnet_tf_ckpt is None) != (args.pixrefer_tf_ckpt is None):
        p.error("--bfmnet_tf_ckpt and --pixrefer_tf_ckpt must be given "
                "together")
    if (args.bfmnet_npz is None) != (args.pixrefer_npz is None):
        p.error("--bfmnet_npz and --pixrefer_npz must be given together")
    if args.rnet_npz is not None and args.rnet_pb is not None:
        p.error("--rnet_npz and --rnet_pb: give one R-Net, not both")
    rnet = args.rnet_npz or args.rnet_pb
    if (args.landmark_model is None) != (rnet is None):
        p.error("--landmark_model and --rnet_npz/--rnet_pb must be given "
                "together (the face photo's identity path needs both)")
    if any(b is not None for b in sources):
        face_model = _resolve_face_model(cfg)
        if args.bfmnet_ckpt is not None:
            synth = SynthesisAssets.from_checkpoints(
                cfg, args.bfmnet_ckpt, args.pixrefer_ckpt,
                face_model=face_model, device=args.device)
        elif args.bfmnet_tf_ckpt is not None:
            synth = SynthesisAssets.from_tf_checkpoints(
                cfg, args.bfmnet_tf_ckpt, args.pixrefer_tf_ckpt,
                face_model=face_model, device=args.device)
        else:
            synth = SynthesisAssets.from_npz(
                cfg, args.bfmnet_npz, args.pixrefer_npz,
                face_model=face_model, device=args.device)
        identity = synthetic_identity(face_model,
                                      img_size=cfg.pixrefer.img_size)
    else:
        synth, identity = SynthesisAssets.demo(cfg, device=args.device)
    if args.identity_npz:
        identity = load_identity_npz(args.identity_npz)
    elif args.landmark_model:
        identity = photo_identity(cfg, args.image, args.landmark_model,
                                  args.rnet_npz, args.rnet_pb, args.device)
    bgs = cycling_backgrounds(args.background_dir, cfg.pixrefer.img_size)
    with synth:
        frames = synth.synthesize(args.image, args.audio, identity,
                                  backgrounds=bgs, out_dir=args.out_dir)
    print(f"wrote {frames.shape[0]} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
