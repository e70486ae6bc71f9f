"""Torch architectures of the data-prep toolchain (the port's own copy of
``voicepuppet_tpu/tools/models_torch.py``, which is torch already).

Fresh implementations of the reference's prep networks
(datasets/models.py) that are **state_dict-compatible with the actual
released checkpoints**: the reference loads
``mobilenetV2_model_checkpoint_metric.pth`` strictly into its
``UnetMobilenetV2`` (make_data_from_GRID.py:505-507) and unpickles the
whole ``DIMModel`` module out of ``BEST_checkpoint.tar``
(make_data_from_GRID.py:510-513).  Checkpoint keys are derived from
module *attribute paths*, so the attribute names below are part of the
checkpoint wire format — exactly like the TF variable names in
``tools/tf_checkpoint.py`` — and mirror datasets/models.py.

Three loaders cover the release formats:

* a plain ``{'state_dict': ...}`` blob (the segmentation .pth),
* a full-module pickle ``{'model': DataParallel(DIMModel)}`` (the
  matting .tar) — loaded WITHOUT the authors' training package via a
  skeleton unpickler that substitutes bare ``nn.Module`` subclasses for
  unimportable classes (module state restores through ``__setstate__``,
  so ``state_dict()`` works on the skeleton),
* ``module.``-prefixed keys from ``nn.DataParallel`` wrapping.

``_load_torch_state`` fails loudly when fewer than ``min_match_frac`` of
the target's parameters match by name+shape, instead of silently keeping
random init.  The networks run on the device their parameters are on
(``model.to(device)``; ``predict_mask`` follows the model).
"""

from __future__ import annotations

import io
import pickle
import types

import torch
import torch.nn as nn
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------

def _skeleton_class(name: str):
    """A bare nn.Module subclass standing in for an unimportable class.

    nn.Module pickles via its ``__dict__`` (``_parameters`` /
    ``_buffers`` / ``_modules``), so a skeleton restores a working
    ``state_dict()`` without the original code."""
    cls = _skeleton_class._cache.get(name)
    if cls is None:
        cls = type(name, (nn.Module,), {"forward": _skeleton_forward})
        _skeleton_class._cache[name] = cls
    return cls


_skeleton_class._cache = {}


def _skeleton_forward(self, *a, **kw):  # pragma: no cover - guard only
    raise RuntimeError(
        f"{type(self).__name__} was reconstructed as a skeleton from a "
        "full-module pickle; only its state_dict is usable")


class _SkeletonUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _skeleton_class(name)


_skeleton_pickle = types.ModuleType("_vp_skeleton_pickle")
_skeleton_pickle.Unpickler = _SkeletonUnpickler
_skeleton_pickle.load = lambda f, **kw: _SkeletonUnpickler(f, **kw).load()
_skeleton_pickle.loads = (
    lambda b, **kw: _SkeletonUnpickler(io.BytesIO(b), **kw).load())


def _load_blob(path: str):
    """torch.load tolerant of both release formats: tensor-only blobs load
    under the safe ``weights_only=True`` path; full-module pickles (the
    DIM ``BEST_checkpoint.tar``) fall back to the skeleton unpickler so
    the authors' training package need not be importable."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return torch.load(path, map_location="cpu", weights_only=False,
                          pickle_module=_skeleton_pickle)


def _load_torch_state(module: nn.Module, path: str,
                      min_match_frac: float = 0.5):
    """Shared checkpoint loader: unwraps common blob layouts (state_dict /
    model keys, pickled modules, DataParallel ``module.`` prefixes) and
    refuses a silent no-op load (strict=False matching ~zero keys)."""
    state = _load_blob(path)
    for key in ("state_dict", "model"):
        if isinstance(state, dict) and key in state:
            state = state[key]
    if isinstance(state, nn.Module):
        # DataParallel wrapping (make_data_from_GRID.py:511 takes .module)
        state = getattr(state, "module", state)
        state = state.state_dict()
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    own = module.state_dict()
    matched = [k for k in state if k in own
               and own[k].shape == state[k].shape]
    if len(matched) < min_match_frac * len(own):
        raise ValueError(
            f"checkpoint {path} matched only {len(matched)}/{len(own)} "
            "parameters — key names likely need remapping")
    module.load_state_dict({k: state[k] for k in matched}, strict=False)
    return len(matched)


# ---------------------------------------------------------------------------
# MobileNetV2 U-Net (person segmentation)
# ---------------------------------------------------------------------------

def _conv_bn_relu6(inp, oup, k, stride, pad):
    return nn.Sequential(nn.Conv2d(inp, oup, k, stride, pad, bias=False),
                         nn.BatchNorm2d(oup), nn.ReLU6(inplace=True))


class InvertedResidual(nn.Module):
    """Public MobileNetV2 block (ref naming: datasets/models.py:147-185).
    The sub-Sequential is attribute ``conv`` with the expand convolution
    present only when expand != 1 — both facts fix the checkpoint keys."""

    def __init__(self, inp, oup, stride, expand):
        super().__init__()
        hidden = int(round(inp * expand))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand != 1:
            layers += [nn.Conv2d(inp, hidden, 1, 1, 0, bias=False),
                       nn.BatchNorm2d(hidden), nn.ReLU6(inplace=True)]
        layers += [nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden,
                             bias=False),
                   nn.BatchNorm2d(hidden), nn.ReLU6(inplace=True),
                   nn.Conv2d(hidden, oup, 1, 1, 0, bias=False),
                   nn.BatchNorm2d(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(nn.Module):
    """Standard MobileNetV2 trunk, features-Sequential layout
    (ref: datasets/models.py:187-240 — keys ``features.N...`` +
    ``classifier.1...``)."""

    # (expand t, channels c, repeats n, stride s) — the public width table
    CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, n_class: int = 1000):
        super().__init__()
        feats = [_conv_bn_relu6(3, 32, 3, 2, 1)]
        inp = 32
        for t, c, n, s in self.CFG:
            for i in range(n):
                feats.append(InvertedResidual(inp, c, s if i == 0 else 1,
                                              t))
                inp = c
        feats.append(_conv_bn_relu6(inp, 1280, 1, 1, 0))
        self.features = nn.Sequential(*feats)
        self.classifier = nn.Sequential(nn.Dropout(0.2),
                                        nn.Linear(1280, n_class))

    def forward(self, x):
        x = self.features(x)
        x = x.mean(3).mean(2)
        return self.classifier(x)


class UnetMobilenetV2(nn.Module):
    """Person-segmentation U-Net over the MobileNetV2 encoder with the
    dconv+InvertedResidual decoder (ref: datasets/models.py:261-355).
    ``mobilenetV2_model_checkpoint_metric.pth``'s ``state_dict`` loads
    key-for-key (make_data_from_GRID.py:505-507).  Output: 1-ch logit map
    at HALF input resolution — the prediction path upsamples ×2
    (make_data_from_GRID.py:574)."""

    # feature indices delimiting the 5 skip scales (ref forward :296-314)
    STAGES = (2, 4, 7, 14, 19)

    def __init__(self, num_classes: int = 1, num_filters: int = 32,
                 pretrained: bool = False, Dropout: float = 0.2):
        super().__init__()
        del num_classes, num_filters, pretrained, Dropout  # API parity only
        self.encoder = MobileNetV2(n_class=1000)
        self.dconv1 = nn.ConvTranspose2d(1280, 96, 4, padding=1, stride=2)
        self.invres1 = InvertedResidual(192, 96, 1, 6)
        self.dconv2 = nn.ConvTranspose2d(96, 32, 4, padding=1, stride=2)
        self.invres2 = InvertedResidual(64, 32, 1, 6)
        self.dconv3 = nn.ConvTranspose2d(32, 24, 4, padding=1, stride=2)
        self.invres3 = InvertedResidual(48, 24, 1, 6)
        self.dconv4 = nn.ConvTranspose2d(24, 16, 4, padding=1, stride=2)
        self.invres4 = InvertedResidual(32, 16, 1, 6)
        self.conv_last = nn.Conv2d(16, 3, 1)
        self.conv_score = nn.Conv2d(3, 1, 1)
        # unused at inference; present in the released state_dict
        self.dconv_final = nn.ConvTranspose2d(1, 1, 4, padding=1, stride=2)

    def forward(self, x):
        skips = []
        lo = 0
        for hi in self.STAGES:
            for n in range(lo, hi):
                x = self.encoder.features[n](x)
            skips.append(x)
            lo = hi
        x1, x2, x3, x4, _ = skips
        up = self.invres1(torch.cat([x4, self.dconv1(x)], dim=1))
        up = self.invres2(torch.cat([x3, self.dconv2(up)], dim=1))
        up = self.invres3(torch.cat([x2, self.dconv3(up)], dim=1))
        up = self.invres4(torch.cat([x1, self.dconv4(up)], dim=1))
        return self.conv_score(self.conv_last(up))

    def load_state(self, path: str):
        return _load_torch_state(self, path)


# ---------------------------------------------------------------------------
# ResNet U-Net (segmentation variant; carried for inventory parity)
# ---------------------------------------------------------------------------

class _TVBasicBlock(nn.Module):
    """torchvision-naming resnet basic block (conv1/bn1/conv2/bn2/
    downsample) so torchvision-trained encoder weights load by key."""

    expansion = 1

    def __init__(self, inp, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(inp, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inp, planes, 1, stride, bias=False),
                          nn.BatchNorm2d(planes))
            if stride != 1 or inp != planes else None)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        s = x if self.downsample is None else self.downsample(x)
        return self.relu(y + s)


class _TVBottleneck(nn.Module):
    """torchvision-naming resnet bottleneck (conv1..conv3, 1-3-1)."""

    expansion = 4

    def __init__(self, inp, planes, stride=1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inp, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inp, out, 1, stride, bias=False),
                          nn.BatchNorm2d(out))
            if stride != 1 or inp != out else None)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        s = x if self.downsample is None else self.downsample(x)
        return self.relu(y + s)


_RESNET_SPECS = {
    "resnet18": (_TVBasicBlock, (2, 2, 2, 2)),
    "resnet34": (_TVBasicBlock, (3, 4, 6, 3)),
    "resnet50": (_TVBottleneck, (3, 4, 6, 3)),
    "resnet101": (_TVBottleneck, (3, 4, 23, 3)),
}


class _TVResNet(nn.Module):
    """Inline resnet trunk with torchvision attribute names (conv1/bn1/
    relu/maxpool/layer1..4/avgpool/fc) — torchvision itself is absent
    from this image."""

    def __init__(self, model: str = "resnet50"):
        super().__init__()
        block, reps = _RESNET_SPECS[model]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inp = 64
        for i, (planes, stride) in enumerate(
                zip((64, 128, 256, 512), (1, 2, 2, 2))):
            stage = [block(inp, planes, stride)]
            inp = planes * block.expansion
            stage += [block(inp, planes) for _ in range(reps[i] - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(inp, 1000)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.fc(torch.flatten(self.avgpool(x), 1))


class _ConvRelu(nn.Module):
    """ref ConvRelu (datasets/models.py:7-18): attributes conv/activation."""

    def __init__(self, in_, out, activate=True):
        super().__init__()
        self.activate = activate
        self.conv = nn.Conv2d(in_, out, 3, padding=1)
        self.activation = nn.ReLU(inplace=True)

    def forward(self, x):
        x = self.conv(x)
        return self.activation(x) if self.activate else x


class _DecoderBlockResnet(nn.Module):
    """ref DecoderBlockResnet (datasets/models.py:37-55): ``block``
    Sequential(ConvRelu, ConvTranspose2d 4/2/1, ReLU)."""

    def __init__(self, in_channels, middle_channels, out_channels):
        super().__init__()
        self.block = nn.Sequential(
            _ConvRelu(in_channels, middle_channels),
            nn.ConvTranspose2d(middle_channels, out_channels, 4,
                               stride=2, padding=1),
            nn.ReLU(inplace=True))

    def forward(self, x):
        return self.block(x)


class UnetResNet(nn.Module):
    """ResNet-encoder U-Net segmentation variant
    (ref: datasets/models.py:57-127).  Attribute names — encoder,
    conv1..conv5 (shared registrations of the encoder stages, exactly as
    the reference registers them), center, dec5..dec0, final — match the
    reference so a checkpoint trained there loads by key.  No released
    checkpoint ships for this model; carried for inventory parity."""

    FILTERS = {"resnet18-34": (512, 512, 256, 128, 64),
               "resnet50-101": (2048, 2048, 1024, 512, 256)}

    def __init__(self, num_classes: int = 1, num_filters: int = 32,
                 pretrained: bool = False, Dropout: float = 0.2,
                 model: str = "resnet50"):
        super().__init__()
        if pretrained:
            raise ValueError("no pretrained resnet weights in this image; "
                             "load a checkpoint via load_state instead")
        self.encoder = _TVResNet(model)
        group = ("resnet18-34" if model in ("resnet18", "resnet34")
                 else "resnet50-101")
        f = self.FILTERS[group]
        nf = num_filters
        self.num_classes = num_classes
        self.pool = nn.MaxPool2d(2, 2)
        self.relu = nn.ReLU(inplace=True)
        # shared registrations (ref :85-92) — state_dict carries both the
        # encoder.* and conv*.* key paths for the same tensors
        self.conv1 = nn.Sequential(self.encoder.conv1, self.encoder.bn1,
                                   self.encoder.relu, self.pool)
        self.conv2 = self.encoder.layer1
        self.conv3 = self.encoder.layer2
        self.conv4 = self.encoder.layer3
        self.conv5 = self.encoder.layer4
        self.center = _DecoderBlockResnet(f[0], nf * 8 * 2, nf * 8)
        self.dec5 = _DecoderBlockResnet(f[1] + nf * 8, nf * 8 * 2, nf * 8)
        self.dec4 = _DecoderBlockResnet(f[2] + nf * 8, nf * 8 * 2, nf * 8)
        self.dec3 = _DecoderBlockResnet(f[3] + nf * 8, nf * 4 * 2, nf * 2)
        self.dec2 = _DecoderBlockResnet(f[4] + nf * 2, nf * 2 * 2,
                                        nf * 2 * 2)
        self.dec1 = _DecoderBlockResnet(nf * 2 * 2, nf * 2 * 2, nf)
        self.dec0 = _ConvRelu(nf, nf)
        self.final = nn.Conv2d(nf, num_classes, kernel_size=1)
        self.dropout_2d = nn.Dropout2d(p=Dropout)

    def forward(self, x):
        conv1 = self.conv1(x)
        conv2 = self.dropout_2d(self.conv2(conv1))
        conv3 = self.dropout_2d(self.conv3(conv2))
        conv4 = self.dropout_2d(self.conv4(conv3))
        conv5 = self.dropout_2d(self.conv5(conv4))
        center = self.center(self.pool(conv5))
        dec5 = self.dec5(torch.cat([center, conv5], 1))
        dec4 = self.dec4(torch.cat([dec5, conv4], 1))
        dec3 = self.dec3(torch.cat([dec4, conv3], 1))
        dec2 = self.dropout_2d(self.dec2(torch.cat([dec3, conv2], 1)))
        return self.final(self.dec0(self.dec1(dec2)))

    def load_state(self, path: str):
        return _load_torch_state(self, path)


# ---------------------------------------------------------------------------
# Deep Image Matting (SegNet/VGG16 encoder-decoder)
# ---------------------------------------------------------------------------

class _CBR(nn.Module):
    """ref conv2DBatchNormRelu (datasets/models.py:358-394): one
    Sequential attribute ``cbr_unit`` = conv [+ bn] [+ relu]."""

    def __init__(self, i, o, k, s, p, with_relu=True):
        super().__init__()
        mods = [nn.Conv2d(i, o, k, stride=s, padding=p)]
        mods.append(nn.BatchNorm2d(o))
        if with_relu:
            mods.append(nn.ReLU(inplace=True))
        self.cbr_unit = nn.Sequential(*mods)

    def forward(self, x):
        return self.cbr_unit(x)


class _SegnetDown(nn.Module):
    """ref segnetDown2/segnetDown3 (datasets/models.py:397-427):
    conv1..convN + argmax maxpool returning indices and pre-pool shape."""

    def __init__(self, in_size, out_size, n_convs):
        super().__init__()
        self.conv1 = _CBR(in_size, out_size, 3, 1, 1)
        self.conv2 = _CBR(out_size, out_size, 3, 1, 1)
        if n_convs == 3:
            self.conv3 = _CBR(out_size, out_size, 3, 1, 1)
        self._n = n_convs
        self.maxpool_with_argmax = nn.MaxPool2d(2, 2, return_indices=True)

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        if self._n == 3:
            x = self.conv3(x)
        shape = x.size()
        x, idx = self.maxpool_with_argmax(x)
        return x, idx, shape


class _SegnetUp1(nn.Module):
    """ref segnetUp1 (datasets/models.py:430-438): unpool + 5x5 conv+bn
    (no relu)."""

    def __init__(self, in_size, out_size):
        super().__init__()
        self.unpool = nn.MaxUnpool2d(2, 2)
        self.conv = _CBR(in_size, out_size, 5, 1, 2, with_relu=False)

    def forward(self, x, idx, shape):
        return self.conv(self.unpool(x, indices=idx, output_size=shape))


class DIMMatting(nn.Module):
    """Deep Image Matting, SegNet/VGG16-style encoder over RGB+trimap
    with argmax-unpooling decoder (ref DIMModel: datasets/models.py:443-
    486).  The released ``BEST_checkpoint.tar`` pickles the whole
    DataParallel-wrapped module (make_data_from_GRID.py:510-513);
    ``load_state`` reconstructs its state_dict via the skeleton
    unpickler and loads it here key-for-key.  Output: [N, H, W] alpha in
    [0, 1].  Input H, W must be divisible by 32 (five 2× poolings)."""

    def __init__(self, n_classes: int = 1, in_channels: int = 4):
        super().__init__()
        self.in_channels = in_channels
        self.down1 = _SegnetDown(in_channels, 64, 2)
        self.down2 = _SegnetDown(64, 128, 2)
        self.down3 = _SegnetDown(128, 256, 3)
        self.down4 = _SegnetDown(256, 512, 3)
        self.down5 = _SegnetDown(512, 512, 3)
        self.up5 = _SegnetUp1(512, 512)
        self.up4 = _SegnetUp1(512, 256)
        self.up3 = _SegnetUp1(256, 128)
        self.up2 = _SegnetUp1(128, 64)
        self.up1 = _SegnetUp1(64, n_classes)
        self.sigmoid = nn.Sigmoid()

    def forward(self, inputs, trimap=None):
        """``forward(nchw_rgba)`` like the reference, or the convenience
        split form ``forward(rgb, trimap)``."""
        if trimap is not None:
            inputs = torch.cat([inputs, trimap], dim=1)
        acts = []
        x = inputs
        for i in range(1, 6):
            x, idx, shape = getattr(self, f"down{i}")(x)
            acts.append((idx, shape))
        for i in range(5, 0, -1):
            idx, shape = acts[i - 1]
            x = getattr(self, f"up{i}")(x, idx, shape)
        return self.sigmoid(torch.squeeze(x, dim=1))

    def load_state(self, path: str):
        return _load_torch_state(self, path)


# ---------------------------------------------------------------------------
# inference helpers
# ---------------------------------------------------------------------------

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def predict_mask(model: UnetMobilenetV2, image, size: int = 320):
    """Segmentation inference (ref: make_data_from_GRID.py:556-589):
    aspect-preserving resize capped at ``size`` and rounded UP to a
    multiple of 32, ImageNet normalization, half-res logits upsampled
    ×2 (align_corners=True, ref :574), sigmoid, resize back.  Resizes
    use bilinear (the reference's cv2 LANCZOS4 is unavailable); the
    reference's small-object morphology cleanup lives in the caller
    (prepare_dataset).  Runs on the model's device; returns numpy."""
    import numpy as np
    h, w = image.shape[:2]
    h_n = min(size, h)
    w_n = int(w / h * h_n)
    h_n += (-h_n) % 32
    w_n += (-w_n) % 32
    dev = next(model.parameters()).device
    x = torch.from_numpy(
        np.ascontiguousarray(image[..., :3])).float().permute(2, 0, 1)
    if x.max() > 1.5:
        x = x / 255.0
    x = x.to(dev)
    mean = torch.tensor(_IMAGENET_MEAN, device=dev).view(3, 1, 1)
    std = torch.tensor(_IMAGENET_STD, device=dev).view(3, 1, 1)
    x = (x - mean) / std
    x = F.interpolate(x[None], size=(h_n, w_n), mode="bilinear",
                      align_corners=False)
    with torch.no_grad():
        logit = model(x)
        logit = F.interpolate(logit, scale_factor=2, mode="bilinear",
                              align_corners=True)
    prob = torch.sigmoid(logit)
    prob = F.interpolate(prob, size=(h, w), mode="bilinear",
                         align_corners=False)[0, 0]
    return prob.cpu().numpy()
