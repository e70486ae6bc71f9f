"""Dataset list builders (port of ``voicepuppet_tpu/tools/makelist.py``).

Equivalent of datasets/makelist_bfm.py:15-45 and makelist_pixrefer.py:15-37:
walk a prepared dataset root, count frames per clip folder, and write
"folder|frame_count" lines split train:eval by ``train_by_eval``
(config/params.yml:7).

CLI: ``python -m voicepuppet_torch.tools.makelist --config_path <yml>
[--mode bfm|pixrefer] [--root <path>]``
"""

from __future__ import annotations

import os
from typing import List, Tuple


def count_frames_bfm(folder: str, landmark_name: str,
                     bfmcoeff_name: str = "bfmcoeff.txt",
                     wav_name: str = "audio.wav") -> int:
    """A BFM-style clip is valid only when landmark/bfmcoeff/audio all
    exist (the reference requires all three; makelist_bfm.py:31-33) and
    the landmark and coefficient row counts agree; the frame count is
    that row count."""
    lmk = os.path.join(folder, landmark_name)
    bfm = os.path.join(folder, bfmcoeff_name)
    wav = os.path.join(folder, wav_name)
    if not (os.path.exists(lmk) and os.path.exists(bfm)
            and os.path.exists(wav)):
        return 0

    def rows(path):
        with open(path) as f:
            return sum(1 for line in f if line.strip())

    n = rows(lmk)
    return n if n == rows(bfm) else 0


def count_frames_images(folder: str) -> int:
    """A PixRefer-style clip is a folder of {i}.jpg panel images; count
    the consecutive frames from 0."""
    n = 0
    while os.path.exists(os.path.join(folder, f"{n}.jpg")):
        n += 1
    return n


def collect_clips(root: str, mode: str, landmark_name: str,
                  bfmcoeff_name: str = "bfmcoeff.txt",
                  wav_name: str = "audio.wav") -> List[Tuple[str, int]]:
    clips = []
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        count = (count_frames_bfm(dirpath, landmark_name, bfmcoeff_name,
                                  wav_name)
                 if mode == "bfm" else count_frames_images(dirpath))
        if count > 0:
            clips.append((dirpath, count))
    return clips


def write_dataset(root: str, train_path: str, eval_path: str,
                  mode: str = "bfm", train_by_eval: int = 9,
                  landmark_name: str = "landmark.txt",
                  bfmcoeff_name: str = "bfmcoeff.txt",
                  wav_name: str = "audio.wav") -> Tuple[int, int]:
    """ref: makelist_bfm.py write_dataset — every (train_by_eval+1)-th clip
    goes to the eval list."""
    clips = collect_clips(root, mode, landmark_name, bfmcoeff_name,
                          wav_name)
    os.makedirs(os.path.dirname(os.path.abspath(train_path)), exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(eval_path)), exist_ok=True)
    n_train = n_eval = 0
    with open(train_path, "w") as ftr, open(eval_path, "w") as fev:
        for i, (folder, count) in enumerate(clips):
            line = f"{folder}|{count}\n"
            if (i + 1) % (train_by_eval + 1) == 0:
                fev.write(line)
                n_eval += 1
            else:
                ftr.write(line)
                n_train += 1
    return n_train, n_eval


def main(argv=None):
    import argparse
    from voicepuppet_torch.config import load_config

    p = argparse.ArgumentParser()
    p.add_argument("--config_path", default=None)
    p.add_argument("--mode", choices=("bfm", "pixrefer"), default="bfm")
    p.add_argument("--root", default=None)
    args = p.parse_args(argv)
    cfg = load_config(args.config_path)
    root = args.root or cfg.dataset.root_path
    n_train, n_eval = write_dataset(
        root, cfg.dataset.train_dataset_path, cfg.dataset.eval_dataset_path,
        args.mode, cfg.dataset.train_by_eval, cfg.dataset.landmark_name,
        cfg.dataset.bfmcoeff_name, cfg.dataset.wav_name)
    print(f"wrote {n_train} train / {n_eval} eval clips")


if __name__ == "__main__":
    main()
