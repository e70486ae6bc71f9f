"""The system under test, ``voicepuppet_torch``, built from a
configuration file and the benchmark's inputs.  The only module of the
benchmark's serving and training glue that imports the system (the
drivers reach it through here)."""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_config(config: dict):
    """The system's ``Config`` with the configuration file's sizes."""
    from voicepuppet_torch import config as vc
    kw = {}
    if "mel" in config:
        kw["mel"] = vc.MelConfig(**config["mel"])
    if "bfmnet" in config:
        b = config["bfmnet"]
        kw["bfmnet"] = vc.BFMNetConfig(
            thinresnet_output_channels=b["thinresnet_output_channels"],
            encode_embedding_size=b["encode_embedding_size"],
            rnn_hidden_size=b["rnn_hidden_size"],
            rnn_layers=b["rnn_layers"],
            bfm_coeff_size=b["bfm_coeff_size"],
            backbone_width_mult=b["backbone_width_mult"])
    p = config["pixrefer"]
    kw["pixrefer"] = vc.PixReferConfig(
        ngf=p["ngf"], ndf=p.get("ndf", 64), img_size=p["img_size"],
        l1_weight=p.get("l1_weight", 500.0),
        gan_weight=p.get("gan_weight", 1.0),
        batch_size=p.get("batch_size", 2),
        crop_ratio=p.get("crop_ratio", 0.9),
        training=vc.TrainingConfig(**p["training"]) if "training" in p
        else vc.PixReferConfig().training)
    return vc.Config(frame_rate=config.get("frame_rate", 25), **kw)


def tf32_flags():
    """The two TF32 switches as the system left them."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def synthesizer(config: dict, face_arrays: dict, bfm_state, g_state,
                chunk: int, raster_group: int, device):
    from voicepuppet_torch.face3d.bfm import BFMModel
    from voicepuppet_torch.pipeline.synthesize import Synthesizer
    return Synthesizer(
        port_config(config), BFMModel(**face_arrays), bfm_state, g_state,
        chunk=chunk, raster_size=config["raster"]["size"],
        raster_bb=config["raster"]["bb"],
        gan_dtype=DTYPES[config["pixrefer"]["conv_dtype"]],
        bfmnet_dtype=DTYPES[config["bfmnet"]["dtype"]],
        transfer_format=config["transfer_format"],
        drain_workers=config["drain_workers"], raster_group=raster_group,
        device=device)


def identity(ident: dict):
    from voicepuppet_torch.pipeline.synthesize import Identity
    return Identity(bfmcoeff=np.asarray(ident["bfmcoeff"], np.float32),
                    transform_params=np.asarray(ident["transform_params"]),
                    center_x=int(ident["center_x"]),
                    center_y=int(ident["center_y"]),
                    ratio=float(ident["ratio"]))


def constant_background(bg):
    from voicepuppet_torch.pipeline.synthesize import constant_background
    return constant_background(bg)


def streaming(synth, ident, panel: np.ndarray, background: np.ndarray,
              ctx_left: int, ctx_right: int):
    from voicepuppet_torch.pipeline.streaming import StreamingSynthesizer
    s = synth.img_size
    return StreamingSynthesizer(
        synth, ident, panel[:, s:2 * s],
        panel[:, :s] * panel[:, 2 * s:3 * s], background=background,
        ctx_left=ctx_left, ctx_right=ctx_right)


def render_colors(verts, colors, tri, h: int, w: int, group: int):
    """The system's raster entry (K1, or K4 with ``group`` > 0)."""
    from voicepuppet_torch.ops import render_colors_auto
    return render_colors_auto(verts, colors, tri, h=h, w=w, group=group)


def pixrefer_trainer(config: dict, g_state, d_state, vgg_state, device):
    """The system's PixRefer trainer and a fresh GAN state on the seed's
    weights (G and D built on the meta device and filled; the VGG trunk
    the trainer drew replaced by the seed's)."""
    from voicepuppet_torch.models import pixrefer as px
    from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer
    from voicepuppet_torch.train.state import GANTrainState
    cfg = port_config(config)
    dtype = DTYPES[config["pixrefer"]["dtype"]]
    trainer = PixReferTrainer(cfg, train_dtype=dtype, device=device)
    trainer.vgg.load_state_dict(vgg_state)
    with torch.device("meta"):
        gen = px.PixReferNet(cfg.pixrefer, dtype)
        disc = px.Discriminator(cfg.pixrefer.ndf, dtype=dtype)
    gen = gen.to_empty(device=device)
    gen.load_state_dict(g_state)
    disc = disc.to_empty(device=device)
    disc.load_state_dict(d_state)
    state = GANTrainState(gen, disc, trainer.g_tx(gen.parameters()),
                          trainer.d_tx(disc.parameters()))
    return trainer, state


def pixrefer_batches(config: dict, list_path: str, seeds, device, tags):
    """The system's input pipeline, as its trainer CLI builds it: the list
    file's JPEG clips, one ``PixReferBatcher`` per worker seed in
    ``BackgroundBatches``, ``prefetch_to_device``.  Each batch handed out
    has its (worker, index) appended to ``tags``.  -> (pipeline, the
    device batches)."""
    import dataclasses
    from voicepuppet_torch.data.generators import (BackgroundBatches,
                                                   FileSource,
                                                   PixReferBatcher,
                                                   prefetch_to_device)
    cfg = port_config(config)
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
        cfg.dataset, train_dataset_path=list_path))
    src = FileSource(list_path, cfg, load_images=True)

    def worker(i):
        for j, b in enumerate(PixReferBatcher(cfg, src, seed=seeds[i])):
            yield tuple(b) + ((i, j),)

    bg = BackgroundBatches(worker, num_workers=len(seeds))

    def untag():
        for item in bg:
            tags.append(item[-1])
            yield item[:-1]

    return bg, prefetch_to_device(untag(), device)
