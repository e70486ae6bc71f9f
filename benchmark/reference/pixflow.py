"""The reference's PixFlow serving pipeline: audio and a face panel in,
uint8 frames out, as ``infer_bfm_pixflow.py`` serves them (taylorlu/
voicepuppet, with ``pixflow.py`` ``create_generator`` at :222-255):
whole-clip BFMNet coefficients (the PixRefer reference's coefficient
program, ``serve.Pipeline.coefficients``), the 3DMM decode with no head
motion, the flat z-buffer raster straight into the S² canvas with the
driver's vertex mapping (``(112 - xy·112)·S/224``, ``z·S/224``), then
PixFlowNet's generator on **one frame at a time**, the whole network
each time, with its batch-moment BN over that one frame, composited on
black (``rgb·α + α − 1``), and the YUV 4:2:0 round trip.

Plain torch in float32 with TF32 off, nothing of the system imported.
The generator keeps the system's submodule names, so one state_dict
loads into both.  Departures from ``pixflow.py``:

* NHWC images in and out, NCHW inside (torch's layout); TF 'SAME' convs
  padded explicitly, the 7×7 stride-2 transposed conv padded (4, 3) as
  TF pads it;
* the raster is the order-free z-buffer of ``face.rasterize_winner``
  (largest depth, the smallest triangle id among equals) in place of
  the driver's sequential one, whose frames it equals;
* the driver rasterizes chunks of 8 frames; here the raster takes the
  clip's frames in chunks of ``RASTER_CHUNK``, which changes nothing
  (each frame's raster is its own);
* the frames go through the served transfer (YUV 4:2:0 and back) in
  place of the driver's JPEG files;
* a switch for the lower-precision control, off by default:
  ``Generator.set_quant`` (a function ``(x, w) -> (x, w)`` applied
  before each conv, as ``nets.Generator.set_quant``) and the conv dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import face, nets, serve

RASTER_CHUNK = 8


# ---- the generator ----------------------------------------------------------

class Conv(nets.SameConv2d):
    """A TF 'SAME' conv with a bias, its operands through ``quant``."""

    def __init__(self, in_ch, out_ch, kernel, stride=(1, 1)):
        super().__init__(in_ch, out_ch, kernel, stride, bias=True)
        self.quant = None

    def forward(self, x):
        x, w = nets._operands(self, x, self.weight.to(x.dtype))
        return self._conv_forward(nets.pad_same(x, self.kernel_size,
                                                self.stride),
                                  w, self.bias.to(x.dtype))


class Final7(nn.ConvTranspose2d):
    """TF's 7×7 stride-2 'SAME' transposed conv: the dilated input padded
    4 before and 3 after (torch pads it 4 on both sides, then the last
    row and column are cut)."""

    def __init__(self, in_ch, out_ch):
        super().__init__(in_ch, out_ch, 7, 2, padding=2, bias=True)
        self.quant = None

    def forward(self, x):
        x, w = nets._operands(self, x, self.weight.to(x.dtype))
        y = F.conv_transpose2d(x, w, self.bias.to(x.dtype), 2, 2)
        return y[..., :-1, :-1]


class ResBlock(nn.Module):
    """3×3 conv, BN, leaky ReLU, 3×3 conv, BN, added to the input (the
    published driver runs it with no dropout)."""

    def __init__(self, ch):
        super().__init__()
        self.Conv_0 = Conv(ch, ch, (3, 3))
        self.StatelessBatchNorm_0 = nets.StatelessBatchNorm(ch)
        self.Conv_1 = Conv(ch, ch, (3, 3))
        self.StatelessBatchNorm_1 = nets.StatelessBatchNorm(ch)

    def forward(self, x):
        y = nets.lrelu(self.StatelessBatchNorm_0(self.Conv_0(x)))
        return x + self.StatelessBatchNorm_1(self.Conv_1(y))


class EncoderNet(nn.Module):
    """A 7×7 stride-2 stem, then three 4×4 stride-2 convs, each after a
    leaky ReLU and before a BN."""

    def __init__(self, ngf):
        super().__init__()
        self.stem7 = Conv(3, ngf, (7, 7), (2, 2))
        ch = ngf
        for i, out in enumerate((ngf * 2, ngf * 4, ngf * 8)):
            self.add_module(f"enc_{i + 1}", nets.GenConv(ch, out))
            self.add_module(f"StatelessBatchNorm_{i}",
                            nets.StatelessBatchNorm(out))
            ch = out

    def forward(self, x):
        x = self.stem7(x)
        for i in range(3):
            x = getattr(self, f"StatelessBatchNorm_{i}")(
                getattr(self, f"enc_{i + 1}")(nets.lrelu(x)))
        return x


class Generator(nn.Module):
    """inputs [B,S,S,6] (reference render | current render), fg_ref
    [B,S,S,3] (the reference foreground), NHWC in [-1,1] -> tanh
    [B,S,S,4] float32.  ``dtype``: the convs' compute dtype."""

    def __init__(self, ngf: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder_net = EncoderNet(ngf)
        self.diffnet = EncoderNet(ngf)
        for name in ("pre_resnet", "diff_resnet", "post_resnet"):
            for i in range(2):
                self.add_module(f"{name}_{i + 1}", ResBlock(ngf * 8))
        ch = ngf * 8
        for i, out in enumerate((ngf * 8, ngf * 4, ngf * 2)):
            self.add_module(f"decoder_{i}", nets.GenDeconv(ch, out))
            self.add_module(f"StatelessBatchNorm_{i}",
                            nets.StatelessBatchNorm(out))
            ch = out
        self.final7 = Final7(ch, 4)

    def set_quant(self, quant):
        for m in self.modules():
            if hasattr(m, "quant"):
                m.quant = quant

    def forward(self, inputs, fg_ref):
        x = inputs.permute(0, 3, 1, 2).to(self.dtype)
        fg = fg_ref.permute(0, 3, 1, 2).to(self.dtype)
        encode_feat = self.encoder_net(fg)
        diff_feat = self.diffnet(x[:, 3:]) - self.diffnet(x[:, :3])
        h = self.pre_resnet_2(self.pre_resnet_1(encode_feat))
        d = self.diff_resnet_2(self.diff_resnet_1(diff_feat))
        h = self.post_resnet_2(self.post_resnet_1(h + d))
        for i in range(3):
            h = getattr(self, f"StatelessBatchNorm_{i}")(
                getattr(self, f"decoder_{i}")(F.relu(h)))
        h = self.final7(F.relu(h))
        return torch.tanh(h.float()).permute(0, 2, 3, 1)


class PixFlowNet(nn.Module):
    def __init__(self, ngf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.generator = Generator(ngf, dtype)

    def forward(self, inputs, fg_inputs):
        """-> the black composite [B,S,S,3] in [-1,1]."""
        out = self.generator(inputs, fg_inputs[..., :3])
        alpha = ((out[..., 3:] + 1.0) / 2.0).expand(-1, -1, -1, 3)
        return out[..., :3] * alpha + alpha - 1.0


# ---- the render -------------------------------------------------------------

def canvas_mesh(coeff, fm: face.FaceModel, s: int):
    """coeff [B,257] -> (vertices [B,N,3] in the S² canvas, colours
    [B,N,3] floored to 0..255), with no head motion: the shape rotated by
    zero angles, as the driver's decode rotates it."""
    b = coeff.shape[0]
    angles = torch.zeros((b, 3), device=coeff.device)
    id_c, ex_c = coeff[:, :80], coeff[:, 80:144]
    flat = id_c @ fm.id_base.T + ex_c @ fm.ex_base.T + fm.meanshape.reshape(
        1, -1)
    shape = flat.reshape(b, -1, 3) - fm.recenter[None]
    shape = shape @ face.rotation_matrix(angles)
    _, colors = face.decode(coeff, fm, angles)
    scale = s / 224.0
    xy = (112.0 - shape[..., :2] * 112.0) * scale
    return torch.cat([xy, shape[..., 2:3] * scale], -1).contiguous(), colors


def canvas_renders(coeff, fm: face.FaceModel, s: int):
    """coeff [B,257] -> (uint8 renders [B,S,S,3], vertices, colours,
    raster winner ids)."""
    verts, colors = canvas_mesh(coeff, fm, s)
    winner = face.rasterize_winner(verts, fm.tri, s, s)
    return face.flat_colors(winner, colors, fm.tri), verts, colors, winner


# ---- the pipeline -----------------------------------------------------------

class Pipeline(serve.Pipeline):
    """``config``: the configuration file's dict.  ``mode`` "reference"
    runs everything in float32 with TF32 off; "control" runs it in the
    next precision down: TF32 matmuls and convs, and G's convs on fp8
    operands computed in bfloat16.  The coefficient program and the
    TF32 switch are the PixRefer reference's."""

    def __init__(self, config: dict, bfm_state, g_state, face_arrays: dict,
                 device, mode: str = "reference"):
        if mode not in serve.CONTROL_MODES:
            raise ValueError(mode)
        self.cfg = config
        self.mode = mode
        self.device = torch.device(device)
        self.mel = face.Mel(config["mel"], self.device)
        self.bfmnet = nets.BFMNet(config["bfmnet"])
        self.bfmnet.load_state_dict(bfm_state)
        self.bfmnet.to(self.device).eval()
        self.gen = PixFlowNet(config["pixflow"]["ngf"])
        self.gen.load_state_dict(g_state)
        self.gen.to(self.device).eval()
        if mode == "control":
            self.gen.generator.dtype = torch.bfloat16
            self.gen.generator.set_quant(nets.fp8_operands)
        self.fm = face.face_model_on(face_arrays, self.device)
        self.s = config["pixflow"]["img_size"]
        self.frame_samples = config["mel"]["sample_rate"] // config[
            "frame_rate"]
        self.scale = self.frame_samples // config["mel"]["hop_step"]

    @torch.no_grad()
    def frames_float(self, rows, face3d_ref, fg_ref) -> torch.Tensor:
        """coefficient rows [T,257], refs [S,S,3] in [0,1] -> the frames
        [T,S,S,3] in [0,1], G run on one frame at a time."""
        out = []
        ref = nets.preprocess(face3d_ref[None])
        fg = nets.preprocess(fg_ref[None])
        fg_inputs = torch.cat([fg, torch.zeros_like(fg)], -1)
        for start in range(0, rows.shape[0], RASTER_CHUNK):
            imgs = canvas_renders(rows[start:start + RASTER_CHUNK], self.fm,
                                  self.s)[0]
            for img in imgs:
                cur = nets.preprocess(img[None].float() / 255.0)
                out.append(nets.deprocess(self.gen(torch.cat([ref, cur], -1),
                                                   fg_inputs)))
        return torch.cat(out)

    @torch.no_grad()
    def clip_frames(self, pcm: np.ndarray, identity: dict,
                    panel: np.ndarray) -> np.ndarray:
        """A whole clip -> uint8 [T,S,S,3], through the YUV round trip."""
        rows = self.coeff_rows(identity, self.coefficients(pcm))
        face3d_ref, fg_ref = self.refs(panel)
        frames = self.frames_float(rows, face3d_ref, fg_ref)
        return face.unpack_yuv420(face.pack_yuv420(frames).cpu().numpy(),
                                  self.s)
