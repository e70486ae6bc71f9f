"""The reference's serving pipeline: audio and a face panel in, uint8
frames out, as ``infer_bfmvid.py`` serves them: whole-clip coefficients
(bucketed, masked in time), the idle head sway, the 3DMM decode and flat
raster at 224², resize and paste, PixRefer G with its batch moments taken
over each chunk (a last chunk padded with zero coefficients to its
bucket), compositing over the background, and the YUV 4:2:0 round trip.
The streaming form keeps the GRU state across blocks and encodes each
block's window of context."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from benchmark.reference import face, nets

CONTROL_MODES = ("reference", "control")


class Pipeline:
    """``config``: the configuration file's dict.  ``mode`` "reference"
    runs everything in float32 with TF32 off; "control" runs it in the
    next precision down: TF32 matmuls and convs, and G's convs on fp8
    operands computed in bfloat16."""

    def __init__(self, config: dict, bfm_state, g_state, face_arrays: dict,
                 device, mode: str = "reference"):
        if mode not in CONTROL_MODES:
            raise ValueError(mode)
        self.cfg = config
        self.mode = mode
        self.device = torch.device(device)
        self.mel = face.Mel(config["mel"], self.device)
        self.bfmnet = nets.BFMNet(config["bfmnet"])
        self.bfmnet.load_state_dict(bfm_state)
        self.bfmnet.to(self.device).eval()
        self.gen = nets.PixReferNet(config["pixrefer"]["ngf"])
        self.gen.load_state_dict(g_state)
        self.gen.to(self.device).eval()
        if mode == "control":
            self.gen.generator.dtype = torch.bfloat16
            self.gen.generator.set_quant(nets.fp8_operands)
        self.fm = face.face_model_on(face_arrays, self.device)
        self.s = config["pixrefer"]["img_size"]
        self.raster = config["raster"]["size"]
        self.frame_samples = config["mel"]["sample_rate"] // config[
            "frame_rate"]
        self.scale = self.frame_samples // config["mel"]["hop_step"]

    def __enter__(self):
        nets.set_tf32(self.mode == "control")
        return self

    def __exit__(self, *exc):
        nets.set_tf32(False)
        return False

    # ---- coefficients --------------------------------------------------------
    @torch.no_grad()
    def coefficients(self, pcm: np.ndarray, ear_seed: int = 0):
        """pcm -> expression coefficients [T, 64]: the clip padded to its
        bucket, mel rows past T*5 masked at every stage."""
        t = int(1 + pcm.shape[0] / self.frame_samples)
        tb = face.coeff_bucket(t)
        n = face.pcm_length_for_frames(tb, self.cfg["mel"], self.scale)
        pcm = np.pad(pcm, (0, max(0, n - pcm.shape[0])))[:n][None]
        ear = np.zeros((1, tb, 1), np.float32)
        ear[:, :t] = np.random.RandomState(ear_seed).rand(1, t, 1).astype(
            np.float32) / 100.0
        dev = self.device
        mel = self.mel(torch.as_tensor(pcm, dtype=torch.float32, device=dev))
        exp = self.bfmnet(torch.as_tensor(ear, device=dev), mel,
                          torch.tensor([t], device=dev), mask_time=True)
        return exp[0, :t]

    def coeff_rows(self, identity: dict, exp):
        """[T,64] expressions -> [T,257] rows (identity | exp | rest)."""
        idc = torch.as_tensor(np.asarray(identity["bfmcoeff"], np.float32),
                              device=self.device)
        t = exp.shape[0]
        return torch.cat([idc[:, :80].expand(t, -1), exp,
                          idc[:, 144:].expand(t, -1)], dim=-1)

    # ---- frames --------------------------------------------------------------
    def refs(self, panel: np.ndarray):
        s = self.s
        p = torch.as_tensor(np.asarray(panel, np.float32), device=self.device)
        return p[:, s:2 * s], p[:, :s] * p[:, 2 * s:3 * s]

    def generator_inputs(self, coeff, angles, identity: dict, face3d_ref,
                         fg_ref):
        return generator_inputs(self.fm, self.s, self.raster, coeff, angles,
                                identity, face3d_ref, fg_ref)

    @torch.no_grad()
    def chunk_frames(self, coeff, angles, n: int, identity: dict,
                     face3d_ref, fg_ref, background) -> np.ndarray:
        """One padded chunk -> its first ``n`` frames, uint8 [n,S,S,3]."""
        inputs, fg_inputs, _ = self.generator_inputs(
            coeff, angles, identity, face3d_ref, fg_ref)
        bg = nets.preprocess(background[None].expand(coeff.shape[0], -1, -1,
                                                     -1))
        outputs, _, _ = self.gen(inputs, fg_inputs, bg)
        packed = face.pack_yuv420(nets.deprocess(outputs))
        return face.unpack_yuv420(packed[:n].cpu().numpy(), self.s)

    @torch.no_grad()
    def clip_frames(self, pcm: np.ndarray, identity: dict, panel: np.ndarray,
                    background: np.ndarray, chunk: int) -> np.ndarray:
        """A whole clip, as the batch path serves it."""
        rows = self.coeff_rows(identity, self.coefficients(pcm))
        t = rows.shape[0]
        angles = torch.as_tensor(face.head_sway(t)[0], device=self.device)
        face3d_ref, fg_ref = self.refs(panel)
        bg = torch.as_tensor(np.asarray(background, np.float32),
                             device=self.device)
        out = np.zeros((t, self.s, self.s, 3), np.uint8)
        for start in range(0, t, chunk):
            n = min(chunk, t - start)
            cc = face.tail_bucket(n, chunk) if n < chunk else chunk
            coeff = torch.zeros((cc, 257), device=self.device)
            coeff[:n] = rows[start:start + n]
            ang = torch.zeros((cc, 3), device=self.device)
            ang[:n] = angles[start:start + n]
            out[start:start + n] = self.chunk_frames(
                coeff, ang, n, identity, face3d_ref, fg_ref, bg)
        return out

    # ---- streaming -------------------------------------------------------------
    @torch.no_grad()
    def stream_blocks(self, pcm: np.ndarray, identity: dict,
                      panel: np.ndarray, background: np.ndarray, chunk: int,
                      ctx_left: int, ctx_right: int, blocks: int,
                      want: Optional[set] = None, ear_seed: int = 0):
        """The first ``blocks`` full blocks of a live session fed ``pcm``
        -> ({block index: uint8 [chunk,S,S,3]}, {block index: [chunk,64]
        coefficients}) for the blocks in ``want`` (all when None).  Block k covers frames [k*chunk, (k+1)*chunk):
        its coefficients come from the window of frames [k*chunk -
        ctx_left, (k+1)*chunk + ctx_right), zero outside the stream,
        encoded whole and cut to the block, then the GRU carried from
        block k-1; its angles continue the head sway; its ears are the
        session's k-th draw of ``chunk`` values."""
        mel_cfg = self.cfg["mel"]
        w_frames = ctx_left + chunk + ctx_right
        win = mel_cfg["hop_step"] * (w_frames * self.scale - 1) + mel_cfg[
            "win_length"]
        hop = self.scale * mel_cfg["hop_step"]
        rng = np.random.RandomState(ear_seed)
        face3d_ref, fg_ref = self.refs(panel)
        bg = torch.as_tensor(np.asarray(background, np.float32),
                             device=self.device)
        sway = None
        state = None
        out, coeffs = {}, {}
        dev = self.device
        for k in range(blocks):
            s0 = (k * chunk - ctx_left) * hop
            window = np.zeros((win,), np.float32)
            lo, hi = max(0, s0), min(pcm.shape[0], s0 + win)
            if hi > lo:
                window[lo - s0:hi - s0] = pcm[lo:hi]
            ears = rng.rand(1, chunk, 1).astype(np.float32) / 100.0
            mel = self.mel(torch.as_tensor(window[None], device=dev))
            enc = self.bfmnet.encode(mel)[:, ctx_left:ctx_left + chunk]
            exp, state = self.bfmnet.decode(
                enc, torch.as_tensor(ears, device=dev),
                torch.full((1,), chunk, dtype=torch.int64, device=dev),
                rnn_state=state)
            angles, sway = face.head_sway(chunk, state=sway)
            if want is not None and k not in want:
                continue
            coeffs[k] = exp[0]
            rows = self.coeff_rows(identity, exp[0])
            out[k] = self.chunk_frames(
                rows, torch.as_tensor(angles, device=dev), chunk, identity,
                face3d_ref, fg_ref, bg)
        return out, coeffs


def generator_inputs(fm, s: int, rs: int, coeff, angles, identity: dict,
                     face3d_ref, fg_ref):
    """One chunk -> (inputs [C,S,S,6], fg_inputs [C,S,S,6]) in [-1,1]
    and the decoded mesh (vertices, colours, raster winner ids)."""
    out_hw, (ty0, ty1, tx0, tx1), (sy0, sy1, sx0, sx1) = \
        face.paste_geometry(identity, rs, s)
    c = coeff.shape[0]
    verts, colors = face.decode(coeff, fm, angles, float(rs))
    winner = face.rasterize_winner(verts, fm.tri, rs, rs)
    img = face.flat_colors(winner, colors, fm.tri)
    scaled = face.resize_linear(img.float() / 255.0, out_hw)
    canvas = torch.zeros((c, s, s, 3), device=coeff.device)
    canvas[:, ty0:ty1, tx0:tx1] = scaled[:, sy0:sy1, sx0:sx1]
    inputs = torch.cat([face3d_ref[None].expand(c, -1, -1, -1), canvas], -1)
    fg = fg_ref[None].expand(c, -1, -1, -1)
    fg_inputs = torch.cat([fg, torch.zeros_like(fg)], -1)
    return (nets.preprocess(inputs), nets.preprocess(fg_inputs),
            (verts, colors, winner))


def frame_mad(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Mean |a - b| per frame, in 8-bit codes."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return d.reshape(d.shape[0], -1).mean(axis=1)
