"""The networks of the plain reference: BFMNet, the PixRefer generator and
discriminator, and the VGG-16 trunk of the perceptual loss.

Frozen copies of the system's plain model code, as it stood when the
benchmark was defined: the same operations in the same order, the same
submodule names (so one state_dict loads into both), and nothing of the
system imported.  Only what the benchmark's cells run is kept: BFMNet at
inference (running BN moments), the generator and discriminator with
batch-moment BN on one device.

Two departures, both switches of the lower-precision control and off by
default: ``Generator.quant`` (a function ``(x, w) -> (x, w)`` applied
before each of G's convs, so a control can round the convs' operands to
fp8) and the TF32 flags, which the caller sets.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# ---- TF 'SAME' convs ---------------------------------------------------------

def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0):
    ph = same_pads(x.shape[-2], kernel[0], stride[0])
    pw = same_pads(x.shape[-1], kernel[1], stride[1])
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


class SameConv2d(nn.Conv2d):
    def __init__(self, in_ch, out_ch, kernel, stride=(1, 1), groups=1,
                 bias=False):
        super().__init__(in_ch, out_ch, kernel, stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x):
        return self._conv_forward(pad_same(x, self.kernel_size, self.stride),
                                  self.weight.to(x.dtype), None
                                  if self.bias is None
                                  else self.bias.to(x.dtype))


class SameConvTranspose2d(nn.ConvTranspose2d):
    """flax ``ConvTranspose(padding="SAME")`` at k 4, s 2: the dilated
    input padded (2, 2), torch's ``padding=1``."""

    def __init__(self, in_ch, out_ch, kernel=4, stride=2, bias=True):
        super().__init__(in_ch, out_ch, kernel, stride, padding=1, bias=bias)


def max_pool_same(x, window, stride):
    return F.max_pool2d(pad_same(x, window, stride, value=-math.inf),
                        window, stride)


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.2)


# ---- BFMNet (inference) -------------------------------------------------------

class TFBatchNorm(nn.Module):
    """eps 1e-3, offset only, running moments at inference."""

    def __init__(self, ch: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        y = ((xf - self.running_mean.view(shape))
             * torch.rsqrt(self.running_var.view(shape) + 1e-3)
             + self.bias.view(shape))
        return y.to(x.dtype)


class ConvBN(nn.Module):
    def __init__(self, in_ch, features, kernel, stride, activation=F.relu):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, features, kernel, stride)
        self.TFBatchNorm_0 = TFBatchNorm(features)
        self.activation = activation

    def forward(self, x):
        return self.activation(self.TFBatchNorm_0(self.Conv_0(x)))


class InvertedResidual(nn.Module):
    def __init__(self, in_ch, features, expansion=6, dw_kernel=(7, 3),
                 activation=F.relu6):
        super().__init__()
        ch = in_ch * expansion
        self.activation = activation
        self.Conv_0 = SameConv2d(in_ch, ch, (1, 1))
        self.TFBatchNorm_0 = TFBatchNorm(ch)
        self.Conv_1 = SameConv2d(ch, ch, dw_kernel, groups=ch)
        self.TFBatchNorm_1 = TFBatchNorm(ch)
        self.Conv_2 = SameConv2d(ch, features, (1, 1))
        self.TFBatchNorm_2 = TFBatchNorm(features)
        if features != in_ch:
            self.Conv_3 = SameConv2d(in_ch, features, (1, 1))
            self.TFBatchNorm_3 = TFBatchNorm(features)

    def forward(self, x, time_mask=None):
        inputs = x
        act = self.activation
        x = act(self.TFBatchNorm_0(self.Conv_0(x)))
        if time_mask is not None:
            x = torch.where(time_mask, x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        x = act(self.TFBatchNorm_1(self.Conv_1(x)))
        x = self.TFBatchNorm_2(self.Conv_2(x))
        if hasattr(self, "Conv_3"):
            inputs = self.TFBatchNorm_3(self.Conv_3(inputs))
        return x + inputs


class MfccNet(nn.Module):
    _BLOCKS = ((1, 1), (2, 6), (2, 6), (3, 6), (3, 6), (3, 6), (4, 6),
               (4, 6), (4, 6), (4, 6), (5, 6), (5, 6), (5, 6), (6, 6),
               (6, 6), (6, 6), (7, 6))
    _POOL_AFTER = (1, 3, 6, 13)

    def __init__(self, output_channels=256, width_mult=1.0,
                 widths=(32, 64, 64, 128, 192, 256, 256, 256)):
        super().__init__()
        w = lambda f: max(8, int(f * width_mult))
        ch = w(widths[0])
        self.ConvBN_0 = ConvBN(1, ch, (9, 5), (1, 2), F.relu)
        for i, (wi, e) in enumerate(self._BLOCKS):
            out = w(widths[wi])
            self.add_module(f"InvertedResidual_{i}",
                            InvertedResidual(ch, out, e))
            ch = out
        self.ConvBN_1 = ConvBN(ch, output_channels, (1, 1), (1, 1), F.relu)

    def forward(self, x, valid_rows=None):
        if valid_rows is None:
            tmask = None
            m0 = neg = lambda v: v
        else:
            rows = torch.arange(x.shape[2], device=x.device)
            tmask = (rows[None, :] < valid_rows[:, None])[:, None, :, None]
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            ninf = torch.full((), -math.inf, dtype=x.dtype, device=x.device)
            m0 = lambda v: torch.where(tmask, v, zero)
            neg = lambda v: torch.where(tmask, v, ninf)
        x = m0(x)
        x = m0(self.ConvBN_0(x))
        for i in range(len(self._BLOCKS)):
            x = m0(getattr(self, f"InvertedResidual_{i}")(x, tmask))
            if i in self._POOL_AFTER:
                x = m0(max_pool_same(neg(x), (2, 2), (1, 2)))
        return m0(self.ConvBN_1(x)).float()


class MfccEncoder(nn.Module):
    def __init__(self, output_channels=256, embedding_size=256,
                 width_mult=1.0):
        super().__init__()
        self.pooling = (5, 3)
        self.MfccNet_0 = MfccNet(output_channels, width_mult=width_mult)
        self.Dense_0 = nn.Linear(output_channels, embedding_size)

    def forward(self, mfccs, valid_rows=None):
        x = self.MfccNet_0(mfccs[:, None], valid_rows=valid_rows)
        x = max_pool_same(x, self.pooling, self.pooling)
        x = x.flatten(2).transpose(1, 2)
        return leaky_relu(self.Dense_0(x))


class TFGRUCell(nn.Module):
    def __init__(self, in_dim, num_units):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim + num_units, 2 * num_units)
        self.Dense_1 = nn.Linear(in_dim + num_units, num_units)

    def forward(self, h, x):
        gates = torch.sigmoid(self.Dense_0(torch.cat([x, h], dim=-1)))
        r, u = gates.chunk(2, dim=-1)
        c = torch.tanh(self.Dense_1(torch.cat([x, r * h], dim=-1)))
        return u * h + (1 - u) * c


class MaskedGRU(nn.Module):
    """``dynamic_rnn(sequence_length=...)``: outputs past each row's length
    zeroed; the carried state is the output at ``seq_len - 1``."""

    def __init__(self, in_dim, num_units, num_layers=1):
        super().__init__()
        self.num_units = num_units
        self.num_layers = num_layers
        for layer in range(num_layers):
            self.add_module(f"ScanTFGRUCell_{layer}", TFGRUCell(
                in_dim if layer == 0 else num_units, num_units))

    def forward(self, inputs, seq_len, initial_state=None):
        b, t, _ = inputs.shape
        x = inputs
        mask = (torch.arange(t, device=x.device)[None, :]
                < seq_len[:, None])[..., None]
        finals = []
        for layer in range(self.num_layers):
            cell = getattr(self, f"ScanTFGRUCell_{layer}")
            h0 = (x.new_zeros((b, self.num_units)) if initial_state is None
                  else initial_state[layer])
            h = h0
            outs = []
            for i in range(t):
                h = cell(h, x[:, i])
                outs.append(h)
            out = torch.stack(outs, dim=1)
            at_len = torch.clamp(seq_len.long() - 1, 0, t - 1)
            last = out[torch.arange(b, device=x.device), at_len]
            finals.append(torch.where((seq_len > 0)[:, None], last, h0))
            x = out * mask
        return x, finals


class BFMCoeffDecoder(nn.Module):
    def __init__(self, in_dim, bfm_coeff_size=64):
        super().__init__()
        self.bfm_coeff_size = bfm_coeff_size
        self.Dense_0 = nn.Linear(in_dim, 128)
        self.Dense_1 = nn.Linear(128, 64)
        self.Dense_2 = nn.Linear(64, bfm_coeff_size)

    def forward(self, x, ears):
        x = leaky_relu(self.Dense_0(x))
        x = leaky_relu(self.Dense_1(x))
        x = self.Dense_2(x)
        return x + F.pad(ears, (16, self.bfm_coeff_size - 16 - ears.shape[-1]))


class BFMNet(nn.Module):
    """ears [B,T,1], mfccs [B,T*5,80], seq_len [B] -> coeffs [B,T,64]."""

    def __init__(self, c: dict):
        super().__init__()
        emb = c["encode_embedding_size"]
        self.mfcc_encoder = MfccEncoder(c["thinresnet_output_channels"], emb,
                                        width_mult=c["backbone_width_mult"])
        self.rnn_in = nn.Linear(emb, emb)
        self.rnn_module = MaskedGRU(emb, c["rnn_hidden_size"],
                                    c["rnn_layers"])
        self.bfm_coeff_decoder = BFMCoeffDecoder(c["rnn_hidden_size"],
                                                 c["bfm_coeff_size"])
        self.register_buffer("ear_scale",
                             torch.tensor([-2.0, -2.0, -2.0, -4.0]),
                             persistent=False)

    def encode(self, mfccs, valid_rows=None):
        return leaky_relu(self.rnn_in(self.mfcc_encoder(mfccs, valid_rows)))

    def decode(self, x, ears, seq_len, rnn_state=None):
        x, state = self.rnn_module(x, seq_len, initial_state=rnn_state)
        return self.bfm_coeff_decoder(x, ears * self.ear_scale), state

    def forward(self, ears, mfccs, seq_len, mask_time=False):
        valid = seq_len * 5 if mask_time else None
        return self.decode(self.encode(mfccs, valid), ears, seq_len)[0]


# ---- PixRefer -----------------------------------------------------------------

def lrelu(x, a: float = 0.2):
    return F.leaky_relu(x, negative_slope=a)


class StatelessBatchNorm(nn.Module):
    """Batch moments in float32, eps 1e-5, learned scale and offset."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3), keepdim=True)
        mean2 = torch.square(xf).mean(dim=(0, 2, 3), keepdim=True)
        var = mean2 - torch.square(mean)
        inv = torch.rsqrt(var + 1e-5)
        y = ((xf - mean) * inv * self.weight.view(1, -1, 1, 1)
             + self.bias.view(1, -1, 1, 1))
        return y.to(x.dtype)


def _operands(owner, x, w):
    quant = getattr(owner, "quant", None)
    return (x, w) if quant is None else quant(x, w)


class GenConv(nn.Module):
    def __init__(self, in_ch, features):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, features, (4, 4), (2, 2), bias=True)
        self.quant = None

    def forward(self, x):
        c = self.Conv_0
        x, w = _operands(self, x, c.weight.to(x.dtype))
        return c._conv_forward(pad_same(x, c.kernel_size, c.stride), w,
                               c.bias.to(x.dtype))


class GenDeconv(nn.Module):
    def __init__(self, in_ch, features):
        super().__init__()
        self.ConvTranspose_0 = SameConvTranspose2d(in_ch, features, 4, 2)
        self.quant = None

    def forward(self, x):
        c = self.ConvTranspose_0
        x, w = _operands(self, x, c.weight.to(x.dtype))
        return F.conv_transpose2d(x, w, c.bias.to(x.dtype), c.stride,
                                  c.padding)


class Generator(nn.Module):
    """inputs [B,S,S,6], fg_ref [B,S,S,3] NHWC in [-1,1] -> tanh [B,S,S,4]
    float32.  ``dtype``: the convs' compute dtype."""

    def __init__(self, ngf: int = 64, out_channels: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        bn = iter(range(17))

        def add_bn(ch):
            self.add_module(f"StatelessBatchNorm_{next(bn)}",
                            StatelessBatchNorm(ch))

        self.encoder_1 = GenConv(6, ngf)
        ch = ngf
        for i, out in enumerate((ngf * 2, ngf * 2, ngf * 4)):
            self.add_module(f"encoder_{i + 2}", GenConv(ch, out))
            add_bn(out)
            ch = out
        self.encoder_fg_1 = GenConv(3, ngf)
        ch = ngf
        for i, out in enumerate((ngf * 2, ngf * 2, ngf * 4)):
            self.add_module(f"encoder_fg_{i + 2}", GenConv(ch, out))
            add_bn(out)
            ch = out
        enc = [ngf * 8]
        for i, out in enumerate((ngf * 4, ngf * 8, ngf * 8, ngf * 8)):
            self.add_module(f"merged_encoder_{i + 2}", GenConv(enc[-1], out))
            add_bn(out)
            enc.append(out)
        ch = enc[-1]
        for dl, out in enumerate((ngf * 8, ngf * 8, ngf * 4, ngf * 4)):
            skip = len(enc) - dl - 1
            in_ch = ch if dl == 0 else ch + enc[skip]
            self.add_module(f"merged_decoder_{skip + 1}",
                            GenDeconv(in_ch, out))
            add_bn(out)
            ch = out
        face = [ngf, ngf * 2, ngf * 2, ngf * 4]
        for dl, out in enumerate((ngf * 2, ngf * 2, ngf)):
            skip = len(face) - dl - 1
            self.add_module(f"merged2_decoder_{skip + 1}",
                            GenDeconv(ch + face[skip], out))
            add_bn(out)
            ch = out
        self.decoder_1 = GenDeconv(ch + ngf, out_channels)

    def set_quant(self, quant):
        for m in self.modules():
            if isinstance(m, (GenConv, GenDeconv)):
                m.quant = quant

    def forward(self, inputs, fg_ref):
        x = inputs.permute(0, 3, 1, 2).to(self.dtype)
        fg = fg_ref.permute(0, 3, 1, 2).to(self.dtype)
        bn = iter(getattr(self, f"StatelessBatchNorm_{i}") for i in range(17))
        down = lambda name, y: next(bn)(getattr(self, name)(lrelu(y)))
        up = lambda name, y: next(bn)(getattr(self, name)(F.relu(y)))
        layers = [self.encoder_1(x)]
        for i in range(3):
            layers.append(down(f"encoder_{i + 2}", layers[-1]))
        fg_layers = [self.encoder_fg_1(fg)]
        for i in range(3):
            fg_layers.append(down(f"encoder_fg_{i + 2}", fg_layers[-1]))
        merged = [torch.cat([layers[-1], fg_layers[-1]], dim=1)]
        for i in range(4):
            merged.append(down(f"merged_encoder_{i + 2}", merged[-1]))
        num_enc = len(merged)
        for dl in range(4):
            skip = num_enc - dl - 1
            x = (merged[-1] if dl == 0
                 else torch.cat([merged[-1], merged[skip]], dim=1))
            merged.append(up(f"merged_decoder_{skip + 1}", x))
        num_enc2 = len(layers)
        for dl in range(3):
            skip = num_enc2 - dl - 1
            merged.append(up(f"merged2_decoder_{skip + 1}",
                             torch.cat([merged[-1], layers[skip]], dim=1)))
        x = self.decoder_1(F.relu(torch.cat([merged[-1], layers[0]], dim=1)))
        return torch.tanh(x.float()).permute(0, 2, 3, 1)


def composite(gen_out, targets):
    rgb = gen_out[..., :3]
    alpha = ((gen_out[..., 3:] + 1.0) / 2.0).expand(-1, -1, -1, 3)
    outputs = rgb * alpha + targets * (1.0 - alpha)
    outputs_fg = rgb * alpha + alpha - 1.0
    return outputs, alpha, outputs_fg


def preprocess(image):
    return image * 2.0 - 1.0


def deprocess(image):
    return (image + 1.0) / 2.0


class PixReferNet(nn.Module):
    def __init__(self, ngf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.generator = Generator(ngf, 4, dtype)

    def forward(self, inputs, fg_inputs, targets):
        return composite(self.generator(inputs, fg_inputs[..., :3]),
                         targets)


class DiscrimConv(nn.Module):
    def __init__(self, in_ch, features, stride):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(in_ch, features, 4, stride, padding=0)

    def forward(self, x):
        c = self.Conv_0
        return F.conv2d(F.pad(x, (1, 1, 1, 1)), c.weight.to(x.dtype),
                        c.bias.to(x.dtype), stride=self.stride)


class Discriminator(nn.Module):
    def __init__(self, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.layer_1 = DiscrimConv(6, ndf, 2)
        ch = ndf
        for i in range(n_layers):
            out = ndf * min(2 ** (i + 1), 8)
            self.add_module(f"layer_{i + 2}", DiscrimConv(
                ch, out, 1 if i == n_layers - 1 else 2))
            self.add_module(f"StatelessBatchNorm_{i}", StatelessBatchNorm(out))
            ch = out
        self.add_module(f"layer_{n_layers + 2}", DiscrimConv(ch, 1, 1))

    def forward(self, d_inputs, d_targets):
        x = torch.cat([d_inputs, d_targets], dim=-1).permute(0, 3, 1, 2)
        x = lrelu(self.layer_1(x))
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i + 2}")(x)
            x = lrelu(getattr(self, f"StatelessBatchNorm_{i}")(x))
        x = getattr(self, f"layer_{self.n_layers + 2}")(x)
        return torch.sigmoid(x.float()).permute(0, 2, 3, 1)


def discriminator_loss(predict_real, predict_fake, eps: float = 1e-12):
    return torch.mean(-(torch.log(predict_real + eps) * 2.0
                        + torch.log(1.0 - predict_fake + eps)))


def generator_loss(predict_fake, targets, outputs, alphas, masks,
                   perceptual, gan_weight: float, l1_weight: float,
                   eps: float = 1e-12):
    gan = torch.mean(-torch.log(predict_fake + eps))
    l1 = (torch.mean(torch.abs(targets - outputs))
          + torch.mean(torch.abs(masks - alphas)) + torch.mean(perceptual))
    return gan * gan_weight + l1 * l1_weight


# ---- VGG-16 trunk -------------------------------------------------------------

STACKS = ((2, "conv1"), (2, "conv2"), (3, "conv3"), (3, "conv4"))


class VGG16Features(nn.Module):
    def __init__(self, widths=(64, 128, 256, 512)):
        super().__init__()
        ch = 3
        for (reps, name), width in zip(STACKS, widths):
            for j in range(reps):
                self.add_module(f"{name}_{j + 1}",
                                nn.Conv2d(ch, width, 3, padding=1))
                ch = width
        self.requires_grad_(False)

    def forward(self, x, stacks: int = 4) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        ends = []
        for s, (reps, name) in enumerate(STACKS[:stacks]):
            if s:
                x = F.max_pool2d(x, 2, 2)
            for j in range(reps):
                conv = getattr(self, f"{name}_{j + 1}")
                x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
            ends.append(x)
        return ends


def perceptual_loss(vgg, real_fg, fake_fg):
    """conv3_3 L2 content loss: ``sum(diff²) / (2 size)``."""
    with torch.no_grad():
        real_f = vgg(real_fg, stacks=3)[-1]
    fake_f = vgg(fake_fg, stacks=3)[-1]
    diff = (fake_f - real_f).float()
    return torch.sum(torch.square(diff)) / (2.0 * diff.numel())


class ReferenceAdam:
    """optax ``adam(lr, b1)`` (b2 0.999, eps 1e-8, no clipping), in optax's
    order of operations; ``mu`` and ``nu`` per parameter."""

    def __init__(self, params, lr: float, beta1: float, beta2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        self.count += 1
        n = self.count
        b1, b2 = self.b1, self.b2
        bc1 = float(1.0 - torch.tensor(b1) ** n)
        bc2 = float(1.0 - torch.tensor(b2) ** n)
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            if p.grad is None:
                continue
            g = p.grad
            mu.mul_(b1).add_(g * (1.0 - b1))
            nu.mul_(b2).add_((g * g) * (1.0 - b2))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(upd * -self.lr)

    def zero_grad(self):
        for p in self.params:
            p.grad = None


def fp8_operands(x, w):
    """The lower-precision control of a bfloat16 conv: both operands
    rounded to float8 e4m3 with a per-tensor scale (amax to 448), then
    computed as bfloat16."""
    def q(t):
        amax = t.detach().abs().amax().float().clamp(min=1e-12)
        scale = 448.0 / amax
        return ((t.float() * scale).to(torch.float8_e4m3fn).float()
                / scale).to(t.dtype)
    return q(x), q(w)


def set_tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
