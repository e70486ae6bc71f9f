"""Sample streams and batchers feeding the trainers (port of
``voicepuppet_tpu/data/generators.py``): BFMNet, PixRefer, PixFlow,
Pix2Pix, the legacy ATNet and VGNet streams with their PCA, hull and mask
helpers, and the Audio2Exp speech-feature windows.

The reference's tf.data stack (generator/generator.py) becomes plain
Python sample streams and a shuffle-buffer batcher drawing from
``random.Random(seed)``: the same seed and files give the same batches as
the JAX generators.  The BFMNet and ATNet log-mels run per batch on the
trainer's device through the port's ``MelFrontend`` (the reference also
maps ``extract_mfcc`` inside its input pipeline; generator.py:500-502).

Reference semantics kept (see the JAX module for the line references):
the fixed 24-frame slicing with pcm windows ``hop*(24*5-1)+win`` at
offsets ``i*24*640``, the leading-silence trim at top_db 20
(librosa.effects.split re-derived), the per-clip identity averaging, the
``1 - EAR`` eye feature, and PixRefer's random reference frame with the
random crop-resize of the 3-panel target|render|alpha images.  As in the
JAX package, the ears are trimmed with the coefficients (the reference
slices its untrimmed ear array with the trimmed indices).
"""

from __future__ import annotations

import collections
import os
import queue as queue_mod
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from voicepuppet_torch.config import Config


# ---- feature math (ref: generator/generator.py:60-114) ----------------------

def ear_compute(landmarks: np.ndarray) -> np.ndarray:
    """Eye aspect ratio per frame from flattened 68-point landmarks
    [T, 136] (ref: generator.py:82-96) -> [T, 1]."""
    ps = np.asarray(landmarks, np.float64)

    def dist(i, j):
        return np.sqrt((ps[:, i] - ps[:, j]) ** 2
                       + (ps[:, i + 1] - ps[:, j + 1]) ** 2)

    ear1 = (dist(74, 82) + dist(76, 80)) / dist(72, 78)
    ear2 = (dist(86, 94) + dist(88, 92)) / dist(84, 90)
    return (((ear1 + ear2) / 2)[:, None]).astype(np.float32)


def split_bfmcoeff(coeff: np.ndarray):
    """[257] -> the six groups id, exp, tex, angles, gamma, translation
    (ref: generator.py:98-106)."""
    return (coeff[:80], coeff[80:144], coeff[144:224], coeff[224:227],
            coeff[227:254], coeff[254:])


def pose_compute(bfmcoeffs: np.ndarray) -> np.ndarray:
    """Per-frame euler angles (ref: generator.py:108-114)."""
    return np.asarray(bfmcoeffs)[:, 224:227]


def split_silence(pcm: np.ndarray, top_db: float = 20.0,
                  frame_length: int = 2048, hop_length: int = 512
                  ) -> np.ndarray:
    """Non-silent intervals [K, 2] in samples (librosa.effects.split, used
    at generator.py:461): centered RMS frames, a threshold ``top_db`` below
    the loudest frame, runs mapped back to sample indices."""
    x = np.asarray(pcm, np.float32)
    if x.size == 0:
        return np.zeros((0, 2), np.int64)
    pad = frame_length // 2
    xp = np.pad(x, (pad, pad))
    n_frames = 1 + (len(xp) - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    rms = np.sqrt(np.mean(xp[idx].astype(np.float64) ** 2, axis=1))
    ref = rms.max()
    if ref <= 0:
        return np.zeros((0, 2), np.int64)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    edges = np.diff((db > -top_db).astype(np.int8), prepend=0, append=0)
    intervals = np.stack([np.nonzero(edges == 1)[0],
                          np.nonzero(edges == -1)[0]], axis=1) * hop_length
    return np.minimum(intervals, len(x))


# ---- clip sources -------------------------------------------------------------

def _shuffled_pass(source, rng: random.Random):
    """One lazily-shuffled pass over a clip source."""
    if hasattr(source, "shuffled"):
        return source.shuffled(rng)
    clips = list(source)
    rng.shuffle(clips)
    return iter(clips)


def _load_frame(clip, idx):
    """Panel frame ``idx`` of an in-memory or on-disk clip."""
    if "images" in clip:
        return np.asarray(clip["images"][idx], np.float32)
    from voicepuppet_torch.data.loaders import load_image
    return load_image(clip["image_paths"][idx])


class ArraySource:
    """In-memory clips: dicts with keys among {'bfmcoeff' [T,257],
    'landmark' [T,136], 'pcm' [S], 'images' [T,H,3W,3]}."""

    def __init__(self, clips: Sequence[Dict[str, np.ndarray]]):
        self.clips = list(clips)

    def __iter__(self):
        return iter(self.clips)

    def shuffled(self, rng: random.Random):
        order = list(self.clips)
        rng.shuffle(order)
        return iter(order)


class FileSource:
    """The reference's "folder|frame_count" list files (ref:
    generator.py:428-448).  Clips load one at a time."""

    def __init__(self, list_path: str, cfg: Config,
                 load_images: bool = False):
        self.cfg = cfg
        self.load_images = load_images
        with open(list_path) as f:
            self.entries = [line.strip().split("|") for line in f
                            if line.strip()]

    def __iter__(self):
        return self._iter_entries(self.entries)

    def shuffled(self, rng: random.Random):
        """Shuffles the clip order only."""
        order = list(self.entries)
        rng.shuffle(order)
        return self._iter_entries(order)

    def _iter_entries(self, entries):
        from voicepuppet_torch.audio.io import load_audio
        from voicepuppet_torch.data.loaders import (load_landmarks,
                                                    load_text_array)
        d = self.cfg.dataset
        for folder, count in entries:
            count = int(count)
            clip: Dict[str, object] = {"frame_count": count}
            bfm_path = os.path.join(folder, d.bfmcoeff_name)
            lmk_path = os.path.join(folder, d.landmark_name)
            wav_path = os.path.join(folder, d.wav_name)
            if os.path.exists(bfm_path):
                clip["bfmcoeff"] = load_text_array(bfm_path)
            if os.path.exists(lmk_path):
                clip["landmark"] = load_landmarks(lmk_path, norm_size=1.0)
            if os.path.exists(wav_path):
                clip["pcm"] = load_audio(wav_path, self.cfg.mel.sample_rate)
            if self.load_images:
                clip["image_paths"] = [os.path.join(folder, f"{i}.jpg")
                                       for i in range(count)]
            yield clip


# ---- BFMNet stream (ref: generator.py:428-504) ------------------------------

class BFMNetSampleStream:
    """Yields (bfmcoeff [T,257], ear [T,1], pcm [pcm_len], seq_len)."""

    def __init__(self, cfg: Config, source, seed: int = 0):
        self.cfg = cfg
        self.source = source
        self.rng = random.Random(seed)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        cfg = self.cfg
        t = cfg.dataset.fixed_sequence_len
        pcm_len = cfg.pcm_length_for_frames(t)
        while True:
            yielded = False
            for clip in _shuffled_pass(self.source, self.rng):
                if not all(k in clip for k in ("bfmcoeff", "landmark",
                                               "pcm")):
                    continue
                coeffs = np.array(clip["bfmcoeff"], np.float32)
                lmk = clip["landmark"]
                pcm = np.asarray(clip["pcm"], np.float32)
                count = coeffs.shape[0]
                if lmk.shape[0] != count or count <= 0:
                    continue
                ear = 1.0 - ear_compute(lmk)
                intervals = split_silence(pcm, cfg.dataset.silence_top_db)
                if intervals.shape[0] == 0:
                    continue
                start = int(intervals[0][0])
                sil_rm = start // cfg.frame_wav_scale
                pcm = pcm[start:]
                coeffs = coeffs[sil_rm:]
                ear = ear[sil_rm:]
                coeffs[:, :80] = coeffs[:, :80].mean(0, keepdims=True)
                for i in range((count - sil_rm) // t):
                    p_start = i * t * cfg.frame_wav_scale
                    if pcm.shape[0] < p_start + pcm_len:
                        pcm = np.pad(pcm, (0, p_start + pcm_len
                                           - pcm.shape[0]))
                    yield (coeffs[i * t:(i + 1) * t], ear[i * t:(i + 1) * t],
                           pcm[p_start:p_start + pcm_len], t)
                    yielded = True
            if not yielded:
                return


class _ShuffleBuffer:
    """``tf.data.Dataset.shuffle(bufsize)``."""

    def __init__(self, it, bufsize: int, seed: int = 0):
        self.it = iter(it)
        self.buf: List = []
        self.bufsize = max(1, bufsize)
        self.rng = random.Random(seed)

    def __iter__(self):
        for item in self.it:
            if len(self.buf) < self.bufsize:
                self.buf.append(item)
            else:
                j = self.rng.randrange(self.bufsize)
                out, self.buf[j] = self.buf[j], item
                yield out
        self.rng.shuffle(self.buf)
        yield from self.buf
        self.buf = []


class BFMNetBatcher:
    """Batches BFMNet samples: yields ``(coeff [B,T,257], ear [B,T,1],
    mfcc [B,T*5,80], seq_len [B])`` — numpy arrays, the log-mel a tensor
    computed on ``device`` (ref: generator.py:488-504)."""

    def __init__(self, cfg: Config, source, shuffle: bool = True,
                 seed: int = 0, batch_size: Optional[int] = None,
                 device="cuda"):
        from voicepuppet_torch.audio.frontend import MelFrontend
        self.cfg = cfg
        self.source = source
        self.shuffle = shuffle
        self.seed = seed
        self.batch_size = batch_size or cfg.bfmnet.batch_size
        self.frontend = MelFrontend(cfg.mel, device)

    def __iter__(self):
        it = iter(BFMNetSampleStream(self.cfg, self.source, self.seed))
        if self.shuffle:
            it = iter(_ShuffleBuffer(it, self.cfg.dataset.shuffle_bufsize,
                                     self.seed))
        batch = []
        for sample in it:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []

    def _collate(self, batch):
        max_t = max(s[3] for s in batch)
        max_p = max(s[2].shape[0] for s in batch)
        coeff = np.zeros((len(batch), max_t, 257), np.float32)
        ear = np.zeros((len(batch), max_t, 1), np.float32)
        pcm = np.zeros((len(batch), max_p), np.float32)
        seq_len = np.zeros((len(batch),), np.int32)
        for i, (c, e, p, t) in enumerate(batch):
            coeff[i, :t] = c
            ear[i, :t] = e
            pcm[i, :p.shape[0]] = p
            seq_len[i] = t
        with torch.no_grad():
            mfcc = self.frontend(torch.from_numpy(pcm))
        return coeff, ear, mfcc, seq_len


# ---- PixRefer stream (ref: generator.py:924-1040) ---------------------------

def _random_crop_resize(img: np.ndarray, crop_ratio: float,
                        rng: random.Random) -> np.ndarray:
    """Random square crop of [crop_ratio, 1] of the size, resized back
    (ref: generator.py:978-989, per 3-panel image)."""
    from PIL import Image
    s = img.shape[0]
    rsize = rng.randint(int(s * crop_ratio), s)
    rx = rng.randint(0, s - rsize)
    ry = rng.randint(0, s - rsize)
    crop = img[rx:rsize + rx, ry:rsize + ry, :]
    chans = []
    for c0 in range(0, crop.shape[2], 3):
        pil = Image.fromarray(
            (np.clip(crop[:, :, c0:c0 + 3], 0, 1) * 255).astype(np.uint8))
        chans.append(np.asarray(pil.resize((s, s), Image.BILINEAR),
                                np.float32) / 255.0)
    return np.concatenate(chans, axis=2)


def _split_panels(img: np.ndarray, img_size: int) -> np.ndarray:
    """[H, 3W, 3] -> [H, W, 9]: target|render|alpha stacked channelwise
    (ref: generator.py:984-987)."""
    return np.concatenate([img[:, :img_size, :],
                           img[:, img_size:2 * img_size, :],
                           img[:, 2 * img_size:, :]], axis=-1)


class PixReferSampleStream:
    """Yields (inputs [S,S,6] render ref⊕cur, fg_inputs [S,S,6] fg
    ref⊕cur, target [S,S,3], mask [S,S,3]) — the reference pairing
    (generator.py:956-1019) of a random reference frame with each current
    frame, both crop-augmented."""

    def __init__(self, cfg: Config, source, seed: int = 0):
        self.cfg = cfg
        self.source = source
        self.rng = random.Random(seed)

    def _model_cfg(self):
        return self.cfg.pixrefer

    def _pairs(self):
        """(reference, current) panel pairs, forever: yields (inputs
        [S,S,6] render ref⊕cur, fg_inputs [S,S,6] fg ref⊕cur, current
        target [S,S,3], current mask [S,S,3])."""
        mcfg = self._model_cfg()
        s = mcfg.img_size
        while True:
            yielded = False
            for clip in _shuffled_pass(self.source, self.rng):
                n = clip.get("frame_count",
                             len(clip.get("images",
                                          clip.get("image_paths", []))))
                for i in range(n):
                    rnd = self.rng.randrange(n)
                    ref = _random_crop_resize(
                        _split_panels(_load_frame(clip, rnd), s),
                        mcfg.crop_ratio, self.rng)
                    cur = _random_crop_resize(
                        _split_panels(_load_frame(clip, i), s),
                        mcfg.crop_ratio, self.rng)
                    inputs = np.concatenate([ref[..., 3:6], cur[..., 3:6]],
                                            axis=-1).astype(np.float32)
                    fg = [p[..., 0:3] * p[..., 6:9] for p in (ref, cur)]
                    yield (inputs,
                           np.concatenate(fg, axis=-1).astype(np.float32),
                           cur[..., 0:3].astype(np.float32),
                           cur[..., 6:9].astype(np.float32))
                    yielded = True
            if not yielded:
                return

    def __iter__(self):
        return self._pairs()


def _batches(it, batch_size: int, fields: int):
    """Stack consecutive samples of ``it`` into numpy batches."""
    batch = []
    for sample in it:
        batch.append(sample)
        if len(batch) == batch_size:
            yield tuple(np.stack([b[k] for b in batch])
                        for k in range(fields))
            batch = []


class PixReferBatcher:
    """Stacks PixRefer samples (shuffle buffer 100) into numpy batches
    ``(inputs, fg_inputs, targets, masks)``."""

    def __init__(self, cfg: Config, source, shuffle: bool = True,
                 seed: int = 0, batch_size: Optional[int] = None):
        self.cfg = cfg
        self.source = source
        self.shuffle = shuffle
        self.seed = seed
        self.batch_size = batch_size or cfg.pixrefer.batch_size

    def __iter__(self):
        it = iter(PixReferSampleStream(self.cfg, self.source, self.seed))
        if self.shuffle:
            it = iter(_ShuffleBuffer(it, 100, self.seed))
        return _batches(it, self.batch_size, 4)


# ---- PixFlow and Pix2Pix streams (ref: generator.py:507-594, 805-921) -----

class PixFlowSampleStream(PixReferSampleStream):
    """PixFlow pairing (ref: generator.py:837-902): PixRefer's random
    reference frame and crop augmentation at ``cfg.pixflow``'s size,
    yielding (inputs [S,S,6] render ref⊕cur, fg_inputs [S,S,6] fg
    ref⊕cur, masks [S,S,3] current alpha)."""

    def _model_cfg(self):
        return self.cfg.pixflow

    def __iter__(self):
        for inputs, fg_inputs, _target, mask in self._pairs():
            yield inputs, fg_inputs, mask


class PixFlowBatcher:
    """Stacks PixFlow samples (shuffle buffer 100) into numpy batches
    ``(inputs, fg_inputs, masks)``."""

    def __init__(self, cfg: Config, source, shuffle: bool = True,
                 seed: int = 0, batch_size: Optional[int] = None):
        self.cfg = cfg
        self.source = source
        self.shuffle = shuffle
        self.seed = seed
        self.batch_size = batch_size or cfg.pixflow.batch_size

    def __iter__(self):
        it = iter(PixFlowSampleStream(self.cfg, self.source, self.seed))
        if self.shuffle:
            it = iter(_ShuffleBuffer(it, 100, self.seed))
        return _batches(it, self.batch_size, 3)


class Pix2PixSampleStream:
    """The 3-frame sliding window (ref: generator.py:507-594): the
    9-channel input stacks three consecutive rendered faces, two zero
    frames before a 20-frame run's start; yields (inputs [S,S,9], target
    [S,S,3], mask [S,S,3])."""

    def __init__(self, cfg: Config, source, seed: int = 0):
        self.cfg = cfg
        self.source = source
        self.rng = random.Random(seed)

    def __iter__(self):
        cfg = self.cfg
        s = cfg.pixrefer.img_size
        seq_len = 20  # ref: generator.py:527
        while True:
            yielded = False
            for clip in _shuffled_pass(self.source, self.rng):
                n = clip.get("frame_count",
                             len(clip.get("images",
                                          clip.get("image_paths", []))))
                index = 0
                for _ in range(n // seq_len):
                    frames = []
                    for _ in range(seq_len):
                        frames.append(_random_crop_resize(
                            _split_panels(_load_frame(clip, index), s),
                            cfg.pixrefer.crop_ratio, self.rng))
                        index += 1
                    frames = np.asarray(frames)        # [L, S, S, 9]
                    renders = frames[..., 3:6]
                    padded = np.concatenate(
                        [np.zeros((2,) + renders.shape[1:], renders.dtype),
                         renders], axis=0)
                    for j in range(seq_len):
                        yield (np.concatenate(list(padded[j:j + 3]),
                                              axis=-1).astype(np.float32),
                               frames[j, :, :, 0:3].astype(np.float32),
                               frames[j, :, :, 6:9].astype(np.float32))
                        yielded = True
            if not yielded:
                return


class Pix2PixBatcher:
    """Batches the 3-frame-window stream (ref: generator.py:581-594,
    batch 4): (inputs [B,S,S,9], targets [B,S,S,3], masks [B,S,S,3])."""

    def __init__(self, cfg: Config, source, shuffle: bool = True,
                 seed: int = 0, batch_size: int = 4):
        self.cfg = cfg
        self.source = source
        self.shuffle = shuffle
        self.seed = seed
        self.batch_size = batch_size

    def __iter__(self):
        it = iter(Pix2PixSampleStream(self.cfg, self.source, self.seed))
        if self.shuffle:
            it = iter(_ShuffleBuffer(it, 100, self.seed))
        return _batches(it, self.batch_size, 3)


# ---- the legacy ATVGNet streams (ref: generator.py:117-374) -----------------

PCA_FEATURE_SCALE = np.array([0.5, 0.5, 0.5, 1.3, 0.5, 0.5])


def pca_renorm(landmarks: np.ndarray, mean: np.ndarray,
               component: np.ndarray) -> np.ndarray:
    """The reference's "svd renorm" enhancing the mouth, eye and pose
    components (ref: generator.py:201-203, 332-334): project on the first
    six PCA components ``component`` [136, K], rescale each, project
    back."""
    comp = component[:, :6]
    code = (landmarks - mean) @ comp
    code = code * (2 * PCA_FEATURE_SCALE)
    return (code @ comp.T).astype(np.float32)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain: [N,2] -> the hull's vertices
    counter-clockwise (cv2.convexHull's stand-in for the VGNet face mask,
    generator.py:296)."""
    pts = sorted(map(tuple, points.astype(np.float64)))
    if len(pts) <= 2:
        return np.asarray(pts)

    def cross(o, a, b):
        return ((a[0] - o[0]) * (b[1] - o[1])
                - (a[1] - o[1]) * (b[0] - o[0]))

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1])


def face_region_mask(landmark: np.ndarray, img_size: int) -> np.ndarray:
    """The convex-hull face mask dilated by a 5x5 ellipse, 255/256 inside
    (ref: generator.py:292-301): a PIL polygon fill and a scipy grey
    dilation stand in for cv2.fillConvexPoly and cv2.dilate."""
    from PIL import Image, ImageDraw
    from scipy import ndimage
    lmk = landmark.reshape(-1, 2).copy()
    if (lmk < 1).all():
        lmk = lmk * img_size
    hull = convex_hull(lmk)
    img = Image.new("L", (img_size, img_size), 0)
    ImageDraw.Draw(img).polygon([(float(x), float(y)) for x, y in hull],
                                fill=255)
    mask = np.asarray(img, np.uint8)
    # the 5x5 elliptical structuring element (cv2.MORPH_ELLIPSE (5, 5))
    yy, xx = np.mgrid[-2:3, -2:3]
    selem = (xx ** 2 + yy ** 2) <= 4 + 1e-9
    mask = ndimage.grey_dilation(mask, footprint=selem)
    return mask.astype(np.float32) / 256.0


class ATNetSampleStream:
    """ref: generator.py:172-226.  Yields (landmark [25,136], ear [25,1],
    pose [25,3], pcm, example_landmark [136], seq_len); ``pca_component``
    is [136, K]."""

    def __init__(self, cfg: Config, source, pca_mean: np.ndarray,
                 pca_component: np.ndarray, seed: int = 0,
                 img_size: int = 224):
        self.cfg = cfg
        self.source = source
        self.mean = pca_mean
        self.component = pca_component
        self.rng = random.Random(seed)
        self.img_size = img_size

    def __iter__(self):
        cfg = self.cfg
        t = 25  # generator.py:212
        pcm_len = cfg.pcm_length_for_frames(t)
        while True:
            yielded = False
            for clip in _shuffled_pass(self.source, self.rng):
                if not all(k in clip for k in ("bfmcoeff", "landmark",
                                               "pcm")):
                    continue
                coeffs = np.asarray(clip["bfmcoeff"], np.float32)
                lmk = np.array(clip["landmark"], np.float32)
                pcm = np.asarray(clip["pcm"], np.float32)
                if lmk.shape[0] != coeffs.shape[0]:
                    continue
                pose = pose_compute(coeffs)
                ear = ear_compute(lmk)
                # to [-1, 1], then the PCA enhancement (generator.py:198-203)
                lmk = pca_renorm((lmk / self.img_size - 0.5) * 2.0,
                                 self.mean, self.component)
                for i in range(lmk.shape[0] // t):
                    l_s = lmk[i * t:(i + 1) * t]
                    start = int(i * t * cfg.frame_wav_scale)
                    if pcm.shape[0] < start + pcm_len:
                        pcm = np.pad(pcm, (0, start + pcm_len
                                           - pcm.shape[0]))
                    rnd = self.rng.randrange(t)
                    yield (l_s, ear[i * t:(i + 1) * t],
                           pose[i * t:(i + 1) * t],
                           pcm[start:start + pcm_len], l_s[rnd], t)
                    yielded = True
            if not yielded:
                return


class ATNetBatcher:
    """Padded batches with the log-mel on ``device`` (ref:
    generator.py:232-248): yields (landmark [B,T,136], ear [B,T,1], pose
    [B,T,3], mfcc [B,T*5,80] a tensor, example_landmark [B,136], seq_len
    [B])."""

    def __init__(self, cfg: Config, source, pca_mean, pca_component,
                 shuffle: bool = True, seed: int = 0,
                 batch_size: Optional[int] = None, device="cuda"):
        from voicepuppet_torch.audio.frontend import MelFrontend
        self.cfg = cfg
        self.args = (source, pca_mean, pca_component)
        self.shuffle = shuffle
        self.seed = seed
        self.batch_size = batch_size or cfg.atnet.batch_size
        self.frontend = MelFrontend(cfg.mel, device)

    def __iter__(self):
        it = iter(ATNetSampleStream(self.cfg, *self.args, seed=self.seed))
        if self.shuffle:
            it = iter(_ShuffleBuffer(it, 100, self.seed))
        batch = []
        for sample in it:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []

    def _collate(self, batch):
        b = len(batch)
        t = max(s[5] for s in batch)
        out = (np.zeros((b, t, 136), np.float32),
               np.zeros((b, t, 1), np.float32),
               np.zeros((b, t, 3), np.float32),
               np.zeros((b, max(s[3].shape[0] for s in batch)), np.float32),
               np.zeros((b, 136), np.float32),
               np.zeros((b,), np.int32))
        for i, (lmk, ear, pose, pcm, ex, sl) in enumerate(batch):
            out[0][i, :sl] = lmk
            out[1][i, :sl] = ear
            out[2][i, :sl] = pose
            out[3][i, :pcm.shape[0]] = pcm
            out[4][i] = ex
            out[5][i] = sl
        with torch.no_grad():
            mfcc = self.frontend(torch.from_numpy(out[3]))
        return out[0], out[1], out[2], mfcc, out[4], out[5]


class VGNetSampleStream:
    """ref: generator.py:288-354.  Yields (landmark [15,136], mask
    [15,S,S,1], imgs [15,S,S,3], example_landmark [136], example_img
    [S,S,3], seq_len); ``pca_component`` is [136, K]."""

    def __init__(self, cfg: Config, source, pca_mean, pca_component,
                 seed: int = 0):
        self.cfg = cfg
        self.source = source
        self.mean = pca_mean
        self.component = pca_component
        self.rng = random.Random(seed)

    def __iter__(self):
        s = self.cfg.vgnet.img_size
        t = 15  # generator.py:344
        while True:
            yielded = False
            for clip in _shuffled_pass(self.source, self.rng):
                if "landmark" not in clip:
                    continue
                lmk = np.array(clip["landmark"], np.float32) / 224.0
                if "images" in clip:
                    imgs = np.asarray(clip["images"], np.float32)
                else:
                    from voicepuppet_torch.data.loaders import load_image
                    imgs = np.stack([load_image(p, resize=(s, s))
                                     for p in clip.get("image_paths", [])])
                if imgs.shape[0] != lmk.shape[0] or imgs.shape[0] == 0:
                    continue
                masks = np.stack([face_region_mask(m, s)
                                  for m in lmk])[..., None]
                lmk = pca_renorm((lmk - 0.5) * 2.0, self.mean,
                                 self.component)
                for i in range(lmk.shape[0] // t):
                    l_s = lmk[i * t:(i + 1) * t]
                    im_s = imgs[i * t:(i + 1) * t]
                    rnd = self.rng.randrange(t)
                    yield (l_s, masks[i * t:(i + 1) * t], im_s, l_s[rnd],
                           im_s[rnd], t)
                    yielded = True
            if not yielded:
                return


class VGNetBatcher:
    """Stacks the fixed-T VGNet samples (ref: generator.py:356-374):
    yields (landmark [B,15,136], mask [B,15,S,S,1], imgs [B,15,S,S,3],
    example_landmark [B,136], example_img [B,S,S,3], seq_len [B]
    int32)."""

    def __init__(self, cfg: Config, source, pca_mean, pca_component,
                 shuffle: bool = True, seed: int = 0,
                 batch_size: Optional[int] = None):
        self.cfg = cfg
        self.args = (source, pca_mean, pca_component)
        self.shuffle = shuffle
        self.seed = seed
        self.batch_size = batch_size or cfg.vgnet.batch_size

    def __iter__(self):
        it = iter(VGNetSampleStream(self.cfg, *self.args, seed=self.seed))
        if self.shuffle:
            it = iter(_ShuffleBuffer(it, 100, self.seed))
        for batch in _batches(it, self.batch_size, 6):
            yield tuple(a.astype(np.int32 if k == 5 else np.float32)
                        for k, a in enumerate(batch))


# ---- the Audio2Exp stream: speech-feature windows (ref: generator.py:597-802)

def interpolate_features(features: np.ndarray, input_rate: float,
                         output_rate: float,
                         output_len: Optional[int] = None) -> np.ndarray:
    """Per-dimension linear resampling of a feature sequence to the video
    rate (ref: generator.py:670-683)."""
    input_len, num_features = features.shape
    if output_len is None:
        output_len = int(input_len / float(input_rate) * output_rate)
    in_t = np.arange(input_len) / float(input_rate)
    out_t = np.arange(output_len) / float(output_rate)
    out = np.zeros((output_len, num_features))
    for k in range(num_features):
        out[:, k] = np.interp(out_t, in_t, features[:, k])
    return out


def context_windows(features: np.ndarray, left: int = 4,
                    right: int = 3) -> np.ndarray:
    """[T, D] -> [T, left+1+right, D] zero-padded sliding windows (ref:
    generator.py:718-736, 8-frame windows)."""
    t, d = features.shape
    padded = np.concatenate([np.zeros((left, d), features.dtype), features,
                             np.zeros((right, d), features.dtype)])
    return np.stack([padded[i:i + left + 1 + right] for i in range(t)])


class Audio2ExpSampleStream:
    """Speech-feature windows aligned to BFM coefficients (ref:
    generator.py:597-802).  The reference runs a frozen DeepSpeech graph
    inside its generator; here the acoustic model is ``speech_fn(pcm, sr)
    -> [T_feat, D]`` at 50 features a second.  Yields (bfmcoeff [25,257],
    windows [25, 8, D], seq_len)."""

    def __init__(self, cfg: Config, source, speech_fn, seed: int = 0):
        self.cfg = cfg
        self.source = source
        self.speech_fn = speech_fn
        self.rng = random.Random(seed)

    def __iter__(self):
        cfg = self.cfg
        t = 25  # generator.py:763
        feature_rate = cfg.mel.sample_rate / cfg.mel.hop_step / 2.0
        while True:
            yielded = False
            for clip in _shuffled_pass(self.source, self.rng):
                if "bfmcoeff" not in clip or "pcm" not in clip:
                    continue
                coeffs = np.asarray(clip["bfmcoeff"], np.float32)
                pcm = np.asarray(clip["pcm"], np.float32)
                count = coeffs.shape[0]
                num_frames = int(round(pcm.shape[0] / cfg.mel.sample_rate
                                       * cfg.frame_rate))
                feats = interpolate_features(
                    np.asarray(self.speech_fn(pcm, cfg.mel.sample_rate)),
                    feature_rate, cfg.frame_rate, output_len=num_frames)
                if feats.shape[0] < count:
                    feats = np.pad(feats, ((0, count - feats.shape[0]),
                                           (0, 0)))
                for i in range(count // t):
                    yield (coeffs[i * t:(i + 1) * t], context_windows(
                        feats[i * t:(i + 1) * t].astype(np.float32)), t)
                    yielded = True
            if not yielded:
                return


# ---- input pipelining ---------------------------------------------------------

class BackgroundBatches:
    """Batches produced by ``num_workers`` daemon threads into a bounded
    queue, so JPEG decode and augmentation overlap the device step (the
    reference's tf.data ``num_parallel_calls=4``, generator.py:502).
    ``make_iterator(worker_idx)`` builds one batch iterator per worker —
    give each a distinct seed; the order across workers is not
    deterministic, as with tf.data's parallel interleave."""

    _STOP = object()

    def __init__(self, make_iterator, num_workers: int = 4,
                 prefetch: int = 8):
        self._q = queue_mod.Queue(maxsize=max(prefetch, num_workers))
        self._stopping = threading.Event()
        self._threads = []

        def put(item):
            # a bounded put, so a stopping consumer never leaves a producer
            # blocked on a full queue
            while not self._stopping.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return
                except queue_mod.Full:
                    continue

        def run(idx):
            try:
                for batch in make_iterator(idx):
                    if self._stopping.is_set():
                        return
                    put(batch)
            finally:
                put(self._STOP)

        for i in range(num_workers):
            t = threading.Thread(target=run, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)
        self._live = num_workers

    def __iter__(self):
        return self

    def __next__(self):
        while self._live > 0:
            if self._stopping.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            if item is self._STOP:
                self._live -= 1
                continue
            return item
        raise StopIteration

    def close(self):
        """Stop the producers and join them."""
        self._stopping.set()
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5.0)


def _to_device(batch, device: torch.device, stream):
    """One batch -> tensors on ``device``.  On the card each host array is
    copied into pinned memory and sent with ``non_blocking`` on the side
    ``stream``; the returned event marks the copies' end."""
    if device.type != "cuda":
        return tuple(torch.as_tensor(b).to(device) for b in batch), None
    with torch.cuda.stream(stream):
        out = []
        for b in batch:
            t = b if isinstance(b, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(b))
            if t.device.type == "cpu":
                t = t.pin_memory().to(device, non_blocking=True)
            out.append(t)
        done = torch.cuda.Event()
        done.record(stream)
    return tuple(out), done


def prefetch_to_device(iterator, device="cuda", size: int = 2, mesh=None):
    """Keeps ``size`` batches in flight to ``device`` so host work hides
    behind the device step.  On the card the copies run on a side stream;
    a batch is handed out only after the consuming stream waits for its
    copies, and its tensors are marked as used there.

    With ``mesh`` (a ``parallel.mesh.DataGroup``) each global batch is cut
    to this rank's rows before its copy, which is what the trainers' steps
    take (JAX ``prefetch_to_device(iterator, mesh)``)."""
    from voicepuppet_torch.parallel.mesh import rank_rows
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    pending = collections.deque()

    def hand_out():
        batch, done = pending.popleft()
        if done is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for t in batch:
                t.record_stream(current)
        return batch

    for batch in iterator:
        if mesh is not None:
            batch = rank_rows(batch, mesh)
        pending.append(_to_device(batch, device, stream))
        if len(pending) >= size:
            yield hand_out()
    while pending:
        yield hand_out()
