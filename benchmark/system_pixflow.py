"""The system under test serving PixFlowNet, built from a configuration
file with a ``pixflow`` key: the adapter of the PixFlow cell beside
``system.py`` (whose ``port_config`` reads PixRefer's sizes).  With
``system.py``, the only module of the PixFlow cell's glue that imports
the system."""

from __future__ import annotations

import dataclasses

from benchmark import system


def port_config(config: dict):
    """The system's ``Config`` with the configuration file's sizes and
    ``generator="pixflow"``.  A system without the field raises."""
    from voicepuppet_torch import config as vc
    kw = {}
    if "mel" in config:
        kw["mel"] = vc.MelConfig(**config["mel"])
    b = config["bfmnet"]
    kw["bfmnet"] = vc.BFMNetConfig(
        thinresnet_output_channels=b["thinresnet_output_channels"],
        encode_embedding_size=b["encode_embedding_size"],
        rnn_hidden_size=b["rnn_hidden_size"], rnn_layers=b["rnn_layers"],
        bfm_coeff_size=b["bfm_coeff_size"],
        backbone_width_mult=b["backbone_width_mult"])
    p = config["pixflow"]
    kw["pixflow"] = dataclasses.replace(vc.PixFlowConfig(), ngf=p["ngf"],
                                        img_size=p["img_size"])
    return vc.Config(frame_rate=config.get("frame_rate", 25),
                     generator="pixflow", **kw)


def synthesizer(config: dict, face_arrays: dict, bfm_state, g_state,
                chunk: int, raster_group: int, device):
    from voicepuppet_torch.face3d.bfm import BFMModel
    from voicepuppet_torch.pipeline.synthesize import Synthesizer
    synth = Synthesizer(
        port_config(config), BFMModel(**face_arrays), bfm_state, g_state,
        chunk=chunk, raster_size=config["raster"]["size"],
        raster_bb=config["raster"]["bb"],
        gan_dtype=system.DTYPES[config["pixflow"]["conv_dtype"]],
        bfmnet_dtype=system.DTYPES[config["bfmnet"]["dtype"]],
        transfer_format=config["transfer_format"],
        drain_workers=config["drain_workers"], raster_group=raster_group,
        device=device)
    if synth.img_size != config["pixflow"]["img_size"]:
        raise SystemExit(f"the system serves {synth.img_size}², not the "
                         f"configuration's PixFlow size")
    return synth


def recording():
    """The system's span recording (``utils/tracing.py``)."""
    from voicepuppet_torch.utils import tracing
    return tracing.recording()
