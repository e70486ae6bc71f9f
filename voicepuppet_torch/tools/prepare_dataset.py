"""Dataset preparation schedule (port of
``voicepuppet_tpu/tools/prepare_dataset.py``).

Re-architecture of datasets/make_data_from_GRID.py — the 6-step ``Schedule``
dispatcher (make_data_from_GRID.py:51-63) that turns raw talking-head
videos into the training layouts:

  step 1  EAR features from landmark files (:74-107)
  step 2  ffmpeg audio extraction from videos (:110-141)
  step 3  per-frame face landmarks + crops -> landmark.txt + {i}.jpg
          (:144-191; the dlib+mxnet detector is an external asset — a
          ``landmark_fn`` provider callable replaces it)
  step 4  identity/BFM coefficients per frame -> bfmcoeff.txt (:216-320;
          the Deep3DFace R-Net frozen graph is an external asset — an
          ``identity_fn`` provider replaces it)
  step 5  DVP v1 3-panel images at 256 (:323-475)
  step 6  DVP v2 (the PixRefer set maker, :478-700): segmentation ->
          trimap -> matting alpha, plus the rasterized face, written as
          512x1536 ``img|face3d|alpha`` panels.  Segmentation/matting run
          the torch prep models (tools/models_torch.py) when weights are
          available, else a landmark-hull mask fallback.

Every step is resumable (skip-if-output-exists, like
make_data_from_GRID.py:132-133).  Steps 5 and 6 render every clip on the
``device`` (the card unless the caller asks for the CPU): the 3DMM
decode and ``ops.render_colors_auto`` — the flat raster kernel K1 on the
card — in chunks of 16 padded frames, so ⌈T/16⌉ launches per clip; the
segmentation and matting nets run there too.  ``landmark_fn_from`` and
``identity_fn_from`` make the providers of steps 3 and 4 from the port's
``pipeline/detect.py`` landmarks and ``pipeline/rnet.
RNetIdentityProvider``.

CLI: ``python -m voicepuppet_torch.tools.prepare_dataset --step N
[--config_path <yml>] [--device cuda|cpu] <src> <dst>``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable, Optional

import numpy as np
import torch

from voicepuppet_torch.config import Config, load_config
from voicepuppet_torch.data.generators import ear_compute, face_region_mask
from voicepuppet_torch.data.loaders import (load_image, load_text_array,
                                            save_image)

CHUNK = 16      # padded frames per render call


class Schedule:
    """Step dispatcher (ref: make_data_from_GRID.py:51-63)."""

    def __init__(self, cfg: Config,
                 landmark_fn: Optional[Callable] = None,
                 identity_fn: Optional[Callable] = None,
                 seg_model_path: Optional[str] = None,
                 matting_model_path: Optional[str] = None,
                 device="cuda"):
        self.cfg = cfg
        self.landmark_fn = landmark_fn
        self.identity_fn = identity_fn
        self.seg_model_path = seg_model_path
        self.matting_model_path = matting_model_path
        self.device = torch.device(device)
        self._fm = None

    def run(self, step: int, src: str, dst: str):
        handler = {1: self.step1_ear, 2: self.step2_audio,
                   3: self.step3_landmarks, 4: self.step4_bfmcoeff,
                   5: self.step5_panels_v1,
                   6: self.step6_panels_v2}[step]
        return handler(src, dst)

    # ---- step 1: EAR (ref :74-107) ----
    def step1_ear(self, src: str, dst: str):
        done = 0
        for folder in _clip_folders(src):
            lmk_path = os.path.join(folder, self.cfg.dataset.landmark_name)
            out_path = os.path.join(folder, "ear.txt")
            if not os.path.exists(lmk_path) or os.path.exists(out_path):
                continue
            lmk = load_text_array(lmk_path)
            ears = ear_compute(lmk)
            np.savetxt(out_path, ears, fmt="%.6f")
            done += 1
        return done

    # ---- step 2: audio extraction (ref :110-141) ----
    def step2_audio(self, src: str, dst: str):
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is None:
            raise RuntimeError("ffmpeg required for audio extraction")
        done = 0
        sr = self.cfg.mel.sample_rate
        for dirpath, _, files in sorted(os.walk(src)):
            for fn in sorted(files):
                if not fn.lower().endswith((".mpg", ".mp4", ".avi",
                                            ".mov")):
                    continue
                clip = os.path.splitext(fn)[0]
                out_dir = os.path.join(dst, os.path.relpath(dirpath, src),
                                       clip)
                out = os.path.join(out_dir, self.cfg.dataset.wav_name)
                if os.path.exists(out):
                    continue
                os.makedirs(out_dir, exist_ok=True)
                subprocess.run([ffmpeg, "-v", "error", "-i",
                                os.path.join(dirpath, fn), "-ac", "1",
                                "-ar", str(sr), "-y", out], check=False)
                done += 1
        return done

    # ---- step 3: landmarks + crops (ref :144-191) ----
    def step3_landmarks(self, src: str, dst: str):
        if self.landmark_fn is None:
            raise RuntimeError(
                "step 3 needs a landmark provider (the reference uses the "
                "external dlib+mxnet SAT assets; pass landmark_fn="
                "callable(image)->(landmarks[136], cropped_image))")
        done = 0
        for folder in _clip_folders(src):
            out_lmk = os.path.join(folder, self.cfg.dataset.landmark_name)
            if os.path.exists(out_lmk):
                continue
            rows = []
            i = 0
            while os.path.exists(os.path.join(folder, f"raw_{i}.jpg")):
                img = load_image(os.path.join(folder, f"raw_{i}.jpg"))
                lmk, cropped = self.landmark_fn(img)
                rows.append(np.asarray(lmk).reshape(-1))
                save_image(os.path.join(folder, f"{i}.jpg"), cropped)
                i += 1
            if rows:
                np.savetxt(out_lmk, np.stack(rows), fmt="%.3f",
                           delimiter=",")
                done += 1
        return done

    # ---- step 4: identity coefficients (ref :216-320) ----
    def step4_bfmcoeff(self, src: str, dst: str):
        if self.identity_fn is None:
            raise RuntimeError(
                "step 4 needs an identity provider (the reference uses the "
                "Deep3DFace R-Net frozen graph asset; pass identity_fn="
                "callable(image, landmarks)->bfmcoeff[257])")
        done = 0
        for folder in _clip_folders(src):
            lmk_path = os.path.join(folder, self.cfg.dataset.landmark_name)
            out_path = os.path.join(folder,
                                    self.cfg.dataset.bfmcoeff_name)
            if not os.path.exists(lmk_path) or os.path.exists(out_path):
                continue
            lmks = load_text_array(lmk_path)
            rows = []
            for i in range(lmks.shape[0]):
                img = load_image(os.path.join(folder, f"{i}.jpg"))
                rows.append(np.asarray(
                    self.identity_fn(img, lmks[i])).reshape(-1))
            np.savetxt(out_path, np.stack(rows), fmt="%.6f", delimiter=",")
            done += 1
        return done

    # ---- steps 5/6: 3-panel training images (ref :323-700) ----
    def face_model(self):
        """The BFM of ``cfg.model_dir`` (the synthetic one when it holds
        none) on the device, loaded once."""
        if self._fm is None:
            from voicepuppet_torch.face3d import bfm as bfm_mod, morph
            model_path = os.path.join(self.cfg.model_dir,
                                      "BFM_model_front.mat")
            face_model = (bfm_mod.load_bfm(self.cfg.model_dir)
                          if os.path.exists(model_path)
                          else bfm_mod.synthetic_bfm())
            self._fm = morph.device_bfm(face_model, self.device)
        return self._fm

    @torch.no_grad()
    def _render_faces(self, coeffs: np.ndarray, img_size: int,
                      chunk: int = CHUNK) -> np.ndarray:
        """Batched device render of [T,257] -> [T,img_size,img_size,3]
        uint8, one ``render_colors_auto`` call per ``chunk`` padded frames.
        Projections are in the 224 analysis frame; they are scaled to
        ``img_size`` and rendered natively there (sharper than rendering
        at 224 and upscaling — the scaling the infer drivers use)."""
        from voicepuppet_torch.face3d import morph
        from voicepuppet_torch.ops import render_colors_auto
        fm = self.face_model()
        scale = img_size / 224.0
        t = coeffs.shape[0]
        out = np.zeros((t, img_size, img_size, 3), np.uint8)
        for s in range(0, t, chunk):
            n = min(chunk, t - s)
            c = np.zeros((chunk, 257), np.float32)
            c[:n] = coeffs[s:s + n]
            rec = morph.reconstruct(torch.from_numpy(c).to(self.device), fm)
            verts = torch.cat([rec.face_projection * scale, rec.z_buffer],
                              -1).contiguous()
            colors = torch.floor(torch.clamp(rec.face_color, 0.0, 255.0))
            imgs, _ = render_colors_auto(verts, colors, fm.tri, h=img_size,
                                         w=img_size)
            out[s:s + n] = imgs[:n].cpu().numpy()
        return out

    def _alpha_mask(self, img: np.ndarray, lmk: np.ndarray) -> np.ndarray:
        """Foreground alpha: torch seg+matting when weights exist
        (ref :554-589, 654-672), else the landmark convex-hull mask."""
        s = img.shape[0]
        if (self.seg_model_path and os.path.exists(self.seg_model_path)):
            from voicepuppet_torch.tools.models_torch import (
                UnetMobilenetV2, predict_mask)
            if not hasattr(self, "_seg"):
                self._seg = UnetMobilenetV2()
                self._seg.load_state(self.seg_model_path)
                self._seg.eval().to(self.device)
            prob = predict_mask(self._seg, img)
            alpha = np.clip(prob, 0.0, 1.0)
            if (self.matting_model_path
                    and os.path.exists(self.matting_model_path)):
                alpha = self._refine_matting(img, alpha)
            return alpha[..., None].repeat(3, -1).astype(np.float32)
        return face_region_mask(lmk, s)[..., None].repeat(3, -1)

    def _refine_matting(self, img, alpha):
        """Trimap (erode 30 / dilate 20; ref :654-659) + DIM matting on the
        device."""
        from scipy import ndimage
        from voicepuppet_torch.tools.models_torch import DIMMatting
        if not hasattr(self, "_dim"):
            self._dim = DIMMatting()
            self._dim.load_state(self.matting_model_path)
            self._dim.eval().to(self.device)
        fg = ndimage.binary_erosion(alpha > 0.5, iterations=30)
        unknown = ndimage.binary_dilation(alpha > 0.5,
                                          iterations=20) & ~fg
        trimap = fg.astype(np.float32)
        trimap[unknown] = 0.5
        rgb = torch.from_numpy(np.ascontiguousarray(img[..., :3])).float(
        ).permute(2, 0, 1)[None].to(self.device)
        tm = torch.from_numpy(trimap).float()[None, None].to(self.device)
        # DIM's 5 argmax-poolings need H, W divisible by 32 — replicate-pad
        # then crop (the reference runs fixed 320x320 crops, ref :654-672)
        h, w = trimap.shape
        ph, pw = (-h) % 32, (-w) % 32
        if ph or pw:
            import torch.nn.functional as tF
            rgb = tF.pad(rgb, (0, pw, 0, ph), mode="replicate")
            tm = tF.pad(tm, (0, pw, 0, ph), mode="replicate")
        with torch.no_grad():
            out = self._dim(rgb, tm)[0].cpu().numpy()[:h, :w]
        refined = trimap.copy()
        refined[unknown] = out[unknown]
        return refined

    def _make_panels(self, src: str, dst: str, img_size: int):
        done = 0
        for folder in _clip_folders(src):
            lmk_path = os.path.join(folder, self.cfg.dataset.landmark_name)
            coeff_path = os.path.join(folder,
                                      self.cfg.dataset.bfmcoeff_name)
            if not (os.path.exists(lmk_path)
                    and os.path.exists(coeff_path)):
                continue
            out_dir = os.path.join(dst, os.path.relpath(folder, src))
            if os.path.exists(os.path.join(out_dir, "0.jpg")):
                continue
            os.makedirs(out_dir, exist_ok=True)
            lmks = load_text_array(lmk_path)
            coeffs = load_text_array(coeff_path)
            faces = self._render_faces(coeffs, img_size)
            from PIL import Image
            for i in range(min(lmks.shape[0], coeffs.shape[0])):
                path = os.path.join(folder, f"{i}.jpg")
                with Image.open(path) as im:
                    w0, h0 = im.size
                img = load_image(path, resize=(img_size, img_size))
                # landmark.txt is in the original crop's pixel frame;
                # rescale to the resized panel frame so the fallback hull
                # mask stays aligned with the image.
                lmk = (lmks[i].reshape(-1, 2)
                       * np.asarray([img_size / w0, img_size / h0],
                                    np.float32)).reshape(-1)
                face = faces[i].astype(np.float32) / 255.0
                alpha = self._alpha_mask(img, lmk)
                panel = np.concatenate([img, face, alpha], axis=1)
                save_image(os.path.join(out_dir, f"{i}.jpg"), panel)
            done += 1
        return done

    def step5_panels_v1(self, src: str, dst: str):
        return self._make_panels(src, dst, img_size=256)

    def step6_panels_v2(self, src: str, dst: str):
        return self._make_panels(src, dst,
                                 img_size=self.cfg.pixrefer.img_size)


def landmark_fn_from(provider: Callable) -> Callable:
    """Step 3's ``landmark_fn`` from a ``pipeline.detect`` landmark
    provider (RGB image -> 68x2 pixel coordinates, or None): the
    flattened 136 landmarks, with the frame itself as its crop.  A frame
    with no face fails loudly."""
    def landmark_fn(img):
        lmk = provider(img)
        if lmk is None:
            raise ValueError("the landmark provider found no face")
        return np.asarray(lmk, np.float32).reshape(-1), img
    return landmark_fn


def identity_fn_from(rnet) -> Callable:
    """Step 4's ``identity_fn`` from a ``pipeline.rnet.
    RNetIdentityProvider``: the R-Net's 257 coefficients of the frame
    aligned on the five points of its 68 landmarks (the reference's
    alignto_bfm_coeff, infer_bfmvid.py:29-74)."""
    def identity_fn(img, lmk):
        from voicepuppet_torch.pipeline.align import (align_for_identity,
                                                      landmarks68_to_5)
        aligned, _ = align_for_identity(
            img, landmarks68_to_5(np.asarray(lmk).reshape(-1)), rnet.lm3d)
        return rnet.coefficients(aligned)[0]
    return identity_fn


def _clip_folders(root: str):
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        if any(f.endswith((".txt", ".jpg", ".wav")) for f in filenames):
            yield dirpath


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="dataset prep (make_data_from_GRID equivalent)")
    p.add_argument("--config_path", default=None)
    p.add_argument("--step", type=int, required=True, choices=range(1, 7))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    cfg = load_config(args.config_path)
    sched = Schedule(cfg, device=args.device)
    n = sched.run(args.step, args.src, args.dst)
    print(f"step {args.step}: processed {n} items")


if __name__ == "__main__":
    main()
