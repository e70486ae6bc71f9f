"""Inference drivers (port of ``voicepuppet_tpu/pipeline/
infer_drivers.py``), the reference's per-model inference CLIs:

  * :func:`infer_bfmnet` — audio -> BFMNet coefficients (a blink pattern
    in the ear input) -> the mesh with a sweeping yaw -> 672² frames
    through ``render_colors_auto`` (the flat raster K1) in chunks of 8 ->
    mp4 (ref: voicepuppet/bfmnet/infer_bfmnet.py:150-235);
  * :func:`infer_pixrefer` / :func:`infer_pixflow` — a PixRefer or
    PixFlow trainer's generator over a prepared 3-panel frame folder (ref:
    infer_pixrefer.py, infer_pixflow.py);
  * :func:`infer_bfm_pixflow` — audio -> coefficients -> faces rendered by
    K1 at PixFlow's size (512², chunks of 8, no yaw) -> PixFlowNet per
    frame (ref: infer_bfm_pixflow.py);
  * :func:`infer_atvgnet` — the legacy path: audio -> the port's mel ->
    ATNet landmarks -> the VGNet generator in inference mode -> mp4 (ref:
    voicepuppet/atvgnet/infer.py).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from voicepuppet_torch.config import Config


def _blink_ears(t: int) -> np.ndarray:
    """The ear pattern: 0.2 for the first half, 0.9 after
    (ref: infer_bfmnet.py:162-165)."""
    ears = np.full((1, t, 1), 0.9, np.float32)
    ears[0, : t // 2, 0] = 0.2
    return ears


def sweep_yaw(t: int, shift: float = 0.04, bound: float = 0.8
              ) -> np.ndarray:
    """[T] yaw: +``shift`` a frame, turning back past ±``bound``."""
    yaw = np.zeros((t,), np.float32)
    a, s = 0.0, shift
    for i in range(t):
        a += s
        if a > bound or a < -bound:
            s = -s
        yaw[i] = a
    return yaw


@torch.inference_mode()
def render_coeff_video_frames(coeff_seq, face_model, img_size: int = 672,
                              yaw_shift: float = 0.04,
                              yaw_bound: float = 0.8,
                              chunk: int = 8, device="cuda") -> np.ndarray:
    """[T,257] -> [T,img_size,img_size,3] uint8 mesh frames with the
    sweeping yaw (ref: infer_bfmnet.py:203-235).  ``face_model`` is a
    ``BFMModel`` (moved to ``device``) or a ``morph.DeviceBFM``, whose
    device then runs the decode and the raster.

    As in the JAX package, the yaw is applied to the shape itself through
    ``reconstruct_rotation`` (the reference advances a yaw it never passes
    on); the canvas is ``synthesize.render_canvas``'s."""
    from voicepuppet_torch.face3d import morph
    from voicepuppet_torch.pipeline.synthesize import render_canvas

    fm = (face_model if isinstance(face_model, morph.DeviceBFM)
          else morph.device_bfm(face_model, device))
    dev = fm.tri.device
    coeffs = torch.as_tensor(coeff_seq, dtype=torch.float32, device=dev)
    t = coeffs.shape[0]
    yaw = torch.as_tensor(sweep_yaw(t, yaw_shift, yaw_bound), device=dev)
    frames = np.zeros((t, img_size, img_size, 3), np.uint8)
    for start in range(0, t, chunk):
        n = min(chunk, t - start)
        c = torch.zeros((chunk, 257), device=dev)
        c[:n] = coeffs[start:start + n]
        ang = torch.zeros((chunk, 3), device=dev)
        ang[:n, 1] = yaw[start:start + n]
        imgs, _ = render_canvas(c, fm, ang, img_size)
        frames[start:start + n] = imgs[:n].cpu().numpy()
    return frames


@torch.inference_mode()
def predict_blink_expressions(cfg: Config, synthesizer,
                              pcm: np.ndarray) -> torch.Tensor:
    """pcm -> [1, T, 64] through the synthesizer's frontend and BFMNet at
    the clip's own length, with the blink ear pattern."""
    t = int(1 + pcm.shape[0] / cfg.frame_wav_scale)
    pcm_len = cfg.pcm_length_for_frames(t)
    if pcm.shape[0] < pcm_len:
        pcm = np.pad(pcm, (0, pcm_len - pcm.shape[0]))
    dev = synthesizer.device
    mel = synthesizer.frontend(torch.as_tensor(pcm[None, :pcm_len],
                                               device=dev))
    return synthesizer.bfmnet(torch.as_tensor(_blink_ears(t), device=dev),
                              mel, torch.tensor([t], device=dev),
                              mask_time=True)


def infer_bfmnet(cfg: Config, synthesizer, identity, audio_path_or_pcm,
                 out_dir: str = "output",
                 audio_path_for_mux: Optional[str] = None,
                 img_size: int = 672, chunk: int = 8) -> np.ndarray:
    """audio -> coefficient sequence -> mesh video ``bfmnet.mp4`` in
    ``out_dir`` (ref: infer_bfmnet.py:125-235); returns the frames."""
    from voicepuppet_torch.audio.io import load_audio
    from voicepuppet_torch.pipeline.synthesize import splice_coeff_sequence
    from voicepuppet_torch.utils.video import save_image_seq_video

    if isinstance(audio_path_or_pcm, str):
        pcm = load_audio(audio_path_or_pcm, cfg.mel.sample_rate)
        audio_path_for_mux = audio_path_for_mux or audio_path_or_pcm
    else:
        pcm = np.asarray(audio_path_or_pcm, np.float32)
    exp = predict_blink_expressions(cfg, synthesizer, pcm)
    coeff_seq = splice_coeff_sequence(identity.bfmcoeff, exp)
    frames = render_coeff_video_frames(coeff_seq, synthesizer.fm, img_size,
                                       chunk=chunk)
    os.makedirs(out_dir, exist_ok=True)
    save_image_seq_video(frames, os.path.join(out_dir, "bfmnet.mp4"),
                         cfg.frame_rate, audio_path_for_mux)
    return frames


def infer_pixrefer(cfg: Config, trainer, state, panel_paths,
                   out_dir: str = "output") -> np.ndarray:
    """PixRefer over a prepared 3-panel frame folder (ref:
    infer_pixrefer.py): frame 0 is the reference; every frame's rendered
    face drives the generator (``trainer.infer``, float32 convs).  Writes
    ``<i>.jpg`` per frame and returns the frames [T,S,S,3] in [0,1]."""
    from voicepuppet_torch.data.loaders import load_image, save_image
    s = cfg.pixrefer.img_size
    ref = load_image(panel_paths[0])
    face3d_ref = ref[:, s:2 * s, :]
    fg_ref = ref[:, :s, :] * ref[:, 2 * s:, :]
    fg_inputs = np.concatenate([fg_ref, np.zeros_like(fg_ref)],
                               axis=-1)[None]
    frames = []
    os.makedirs(out_dir, exist_ok=True)
    for i, path in enumerate(panel_paths):
        panel = load_image(path)
        inputs = np.concatenate([face3d_ref, panel[:, s:2 * s, :]],
                                axis=-1)[None]
        out, _ = trainer.infer(state, inputs, fg_inputs,
                               panel[:, :s, :][None])
        frame = out[0].cpu().numpy()
        frames.append(frame)
        save_image(os.path.join(out_dir, f"{i}.jpg"), frame)
    return np.stack(frames)


def infer_pixflow(cfg: Config, trainer, state, panel_paths,
                  out_dir: str = "output") -> np.ndarray:
    """PixFlow over a prepared 3-panel frame folder (ref:
    infer_pixflow.py): frame 0's foreground and rendered face are the
    reference, each frame's rendered face the current one.  Writes
    ``<i>.jpg`` per frame and returns the frames [T,S,S,3] in [0,1]."""
    from voicepuppet_torch.data.loaders import load_image
    ref = load_image(panel_paths[0])
    return _pixflow_frames(cfg, trainer, state, ref, (
        load_image(path)[:, cfg.pixflow.img_size:2 * cfg.pixflow.img_size]
        for path in panel_paths), out_dir)


def _pixflow_frames(cfg: Config, trainer, state, panel: np.ndarray,
                    faces, out_dir: str) -> np.ndarray:
    """PixFlowNet on (the panel's rendered face, each of ``faces``) with
    the panel's foreground; ``<i>.jpg`` per frame in ``out_dir``."""
    from voicepuppet_torch.data.loaders import save_image
    s = cfg.pixflow.img_size
    ref_face = panel[:, s:2 * s, :]
    ref_fg = panel[:, :s, :] * (panel[:, 2 * s:3 * s, :]
                                if panel.shape[1] >= 3 * s
                                else np.ones_like(panel[:, :s, :]))
    fg_inputs = np.concatenate([ref_fg, np.zeros_like(ref_fg)],
                               axis=-1)[None]
    frames = []
    os.makedirs(out_dir, exist_ok=True)
    for i, cur in enumerate(faces):
        inputs = np.concatenate([ref_face, cur], axis=-1)[None]
        out, _ = trainer.infer(state, inputs, fg_inputs)
        frame = out[0].cpu().numpy()
        frames.append(frame)
        save_image(os.path.join(out_dir, f"{i}.jpg"), frame)
    return np.stack(frames)


def infer_bfm_pixflow(cfg: Config, synthesizer, pixflow_trainer,
                      pixflow_state, identity, panel: np.ndarray,
                      audio_path_or_pcm, out_dir: str = "output",
                      chunk: int = 8) -> np.ndarray:
    """audio + a reference panel -> coefficients (the synthesizer's
    ``predict_expressions``) -> faces rendered at ``cfg.pixflow.img_size``
    with no yaw (K1, ``ceil(T / chunk)`` launches) -> PixFlowNet frames
    (ref: infer_bfm_pixflow.py).  Returns [T,S,S,3] in [0,1]."""
    from voicepuppet_torch.audio.io import load_audio
    from voicepuppet_torch.pipeline.synthesize import splice_coeff_sequence

    if isinstance(audio_path_or_pcm, str):
        pcm = load_audio(audio_path_or_pcm, cfg.mel.sample_rate)
    else:
        pcm = np.asarray(audio_path_or_pcm, np.float32)
    with torch.inference_mode():
        coeff_seq = splice_coeff_sequence(
            identity.bfmcoeff, synthesizer.predict_expressions(pcm))
    rendered = render_coeff_video_frames(coeff_seq, synthesizer.fm,
                                         img_size=cfg.pixflow.img_size,
                                         yaw_shift=0.0, chunk=chunk)
    return _pixflow_frames(cfg, pixflow_trainer, pixflow_state, panel,
                           (f.astype(np.float32) / 255.0 for f in rendered),
                           out_dir)


def infer_atvgnet(cfg: Config, atnet_trainer, atnet_state, vgnet_trainer,
                  vgnet_state, example_img: np.ndarray,
                  example_landmark: np.ndarray, audio_path_or_pcm,
                  pca_mean: np.ndarray, pca_component: np.ndarray,
                  out_dir: str = "output",
                  audio_path_for_mux: Optional[str] = None) -> np.ndarray:
    """The legacy ATVGNet path (ref: voicepuppet/atvgnet/infer.py): audio
    -> the log-mel on the ATNet trainer's device -> ATNet landmarks (the
    blink ear pattern, zero poses) -> the VGNet generator in inference
    mode -> ``atvg.mp4`` (a PNG sequence without ffmpeg); returns the
    uint8 frames [T,S,S,3].  ``example_landmark`` is the example image's
    136 landmark coordinates in pixels, renormed through the PCA
    enhancement as the training stream does (generator.py:198-203);
    ``pca_component`` is [136, K]."""
    from voicepuppet_torch.audio.frontend import MelFrontend
    from voicepuppet_torch.audio.io import load_audio
    from voicepuppet_torch.data.generators import pca_renorm
    from voicepuppet_torch.utils.video import save_image_seq_video

    if isinstance(audio_path_or_pcm, str):
        pcm = load_audio(audio_path_or_pcm, cfg.mel.sample_rate)
        audio_path_for_mux = audio_path_for_mux or audio_path_or_pcm
    else:
        pcm = np.asarray(audio_path_or_pcm, np.float32)
    t = int(1 + pcm.shape[0] / cfg.frame_wav_scale)
    pcm_len = cfg.pcm_length_for_frames(t)
    if pcm.shape[0] < pcm_len:
        pcm = np.pad(pcm, (0, pcm_len - pcm.shape[0]))
    dev = atnet_trainer.device
    with torch.no_grad():
        mfcc = MelFrontend(cfg.mel, dev)(
            torch.as_tensor(pcm[None, :pcm_len], device=dev))

    img_size = example_img.shape[0]
    lmk = (np.asarray(example_landmark, np.float64) / img_size - 0.5) * 2.0
    lmk = pca_renorm(lmk[None], pca_mean, pca_component)
    seq_len = np.asarray([t], np.int32)
    lmk_seq = atnet_trainer.infer(atnet_state, _blink_ears(t),
                                  np.zeros((1, t, 3), np.float32), mfcc,
                                  lmk, seq_len)
    video, _, _ = vgnet_trainer.generate(
        vgnet_state, np.asarray(example_img[None], np.float32),
        lmk_seq.float(), lmk, seq_len)
    frames = np.clip(video[0].cpu().numpy() * 255.0, 0, 255).astype(
        np.uint8)
    os.makedirs(out_dir, exist_ok=True)
    save_image_seq_video(frames, os.path.join(out_dir, "atvg.mp4"),
                         cfg.frame_rate, audio_path_for_mux)
    return frames
