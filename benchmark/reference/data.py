"""The reference's PixRefer batches, worked out again from the files.

The system's input pipeline draws, for each current frame of a shuffled
pass over the clips, a random reference frame and a random square crop
of each (``random.Random(seed)``), keeps a shuffle buffer of 100 samples
(its own ``random.Random(seed)``) and stacks them in twos; each of its
workers does so with a seed of its own.  Here the same draws are made
without decoding an image (the draws do not depend on the pixels), and
only the samples of the wanted batch are decoded and cropped: a frozen
copy of the reference data path (``generator.py:956-1019``), nothing of
the system imported."""

from __future__ import annotations

import random
from typing import Iterator, List, Tuple

import numpy as np


def read_list(path: str) -> List[Tuple[str, int]]:
    with open(path) as f:
        return [(a, int(b)) for a, b in (line.strip().split("|")
                                         for line in f if line.strip())]


def _crop_draw(s: int, crop_ratio: float, rng: random.Random):
    rsize = rng.randint(int(s * crop_ratio), s)
    return rsize, rng.randint(0, s - rsize), rng.randint(0, s - rsize)


def sample_draws(entries, s: int, crop_ratio: float,
                 rng: random.Random) -> Iterator[tuple]:
    """(folder, ref frame, ref crop, cur frame, cur crop) forever, in the
    pipeline's order of draws."""
    while True:
        order = list(entries)
        rng.shuffle(order)
        for folder, n in order:
            for i in range(n):
                rnd = rng.randrange(n)
                ref_crop = _crop_draw(s, crop_ratio, rng)
                cur_crop = _crop_draw(s, crop_ratio, rng)
                yield folder, rnd, ref_crop, i, cur_crop


def shuffled(it, bufsize: int, seed: int) -> Iterator:
    """``tf.data.Dataset.shuffle(bufsize)`` on an endless stream."""
    rng = random.Random(seed)
    buf = []
    for item in it:
        if len(buf) < bufsize:
            buf.append(item)
        else:
            j = rng.randrange(bufsize)
            out, buf[j] = buf[j], item
            yield out


def batch_draws(list_path: str, s: int, crop_ratio: float, seed: int,
                index: int, batch: int, bufsize: int = 100) -> List[tuple]:
    """The draws of batch ``index`` of the worker seeded ``seed``."""
    it = shuffled(sample_draws(read_list(list_path), s, crop_ratio,
                               random.Random(seed)), bufsize, seed)
    rows = []
    for k, item in enumerate(it):
        if k >= index * batch:
            rows.append(item)
        if len(rows) == batch:
            return rows
    raise RuntimeError("the sample stream ended")


def _load(folder: str, i: int) -> np.ndarray:
    from PIL import Image
    img = Image.open(f"{folder}/{i}.jpg").convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def _crop_resize(img: np.ndarray, crop) -> np.ndarray:
    """[S,S,9] -> the square crop resized back to S, per 3 channels
    through 8-bit PIL bilinear."""
    from PIL import Image
    s = img.shape[0]
    rsize, rx, ry = crop
    c = img[rx:rsize + rx, ry:rsize + ry, :]
    chans = []
    for c0 in range(0, c.shape[2], 3):
        pil = Image.fromarray(
            (np.clip(c[:, :, c0:c0 + 3], 0, 1) * 255).astype(np.uint8))
        chans.append(np.asarray(pil.resize((s, s), Image.BILINEAR),
                                np.float32) / 255.0)
    return np.concatenate(chans, axis=2)


def _panels(img: np.ndarray, s: int) -> np.ndarray:
    return np.concatenate([img[:, :s], img[:, s:2 * s], img[:, 2 * s:]], -1)


def batch(list_path: str, s: int, crop_ratio: float, seed: int, index: int,
          batch_size: int):
    """(inputs [B,S,S,6], fg_inputs [B,S,S,6], targets [B,S,S,3], masks
    [B,S,S,3]) float32 in [0, 1]: render ref | cur, foreground ref | cur,
    the current target and its alpha."""
    rows = []
    for folder, rnd, ref_crop, i, cur_crop in batch_draws(
            list_path, s, crop_ratio, seed, index, batch_size):
        ref = _crop_resize(_panels(_load(folder, rnd), s), ref_crop)
        cur = _crop_resize(_panels(_load(folder, i), s), cur_crop)
        rows.append((np.concatenate([ref[..., 3:6], cur[..., 3:6]], -1),
                     np.concatenate([ref[..., 0:3] * ref[..., 6:9],
                                     cur[..., 0:3] * cur[..., 6:9]], -1),
                     cur[..., 0:3], cur[..., 6:9]))
    return tuple(np.stack([r[k] for r in rows]).astype(np.float32)
                 for k in range(4))
