"""The system under test training PixFlowNet, built from a configuration
file with a ``pixflow`` key: the adapter of the PixFlow training cell
beside ``system.py``.  With ``system.py`` and ``system_pixflow.py`` (its
span recording), the only module of that cell's glue that imports the
system."""

from __future__ import annotations

import dataclasses

import torch

from benchmark import system

SPANS = ("vp.train.d_half", "vp.train.g_const", "vp.train.g_half")


def port_config(config: dict, list_path: str = ""):
    """The system's ``Config`` with the configuration file's PixFlow
    sizes and, where given, the training list file."""
    from voicepuppet_torch import config as vc
    p = config["pixflow"]
    cfg = vc.Config(pixflow=vc.PixFlowConfig(
        ngf=p["ngf"], ndf=p["ndf"], l1_weight=p["l1_weight"],
        gan_weight=p["gan_weight"], img_size=p["img_size"],
        batch_size=p["batch_size"], crop_ratio=p["crop_ratio"],
        training=vc.TrainingConfig(**p["training"])))
    if list_path:
        cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
            cfg.dataset, train_dataset_path=list_path))
    return cfg


def trainer(config: dict, g_state, d_state, device):
    """The system's PixFlow trainer and a fresh GAN state on the seed's
    weights (G and D built on the meta device and filled)."""
    from voicepuppet_torch.models import pixflow as pf
    from voicepuppet_torch.models import pixrefer as px
    from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
    from voicepuppet_torch.train.state import GANTrainState
    cfg = port_config(config)
    dtype = system.DTYPES[config["pixflow"]["dtype"]]
    tr = PixFlowTrainer(cfg, train_dtype=dtype, device=device)
    with torch.device("meta"):
        gen = pf.PixFlowNet(cfg.pixflow, dtype)
        disc = px.Discriminator(cfg.pixflow.ndf, dtype=dtype)
    rates = {m.drop_rate for m in gen.modules()
             if isinstance(m, pf.ResBlock)}
    if rates != {config["pixflow"]["drop_rate"]}:
        raise SystemExit(f"the system's ResBlocks drop out at {rates}")
    gen = gen.to_empty(device=device)
    gen.load_state_dict(g_state)
    disc = disc.to_empty(device=device)
    disc.load_state_dict(d_state)
    state = GANTrainState(gen, disc, tr.g_tx(gen.parameters()),
                          tr.d_tx(disc.parameters()))
    return tr, state


def check_spans(device, ngf: int = 4, size: int = 64, batch: int = 3):
    """One step of a small PixFlow trainer on ``device`` under a span
    recording: the spans this cell's metrics read, ``vp.train.g_const``
    inside ``vp.train.d_half``, each once.  A system without them raises
    ``SystemExit`` before the cell's data is made."""
    from voicepuppet_torch import config as vc
    from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
    from voicepuppet_torch.utils import tracing
    cfg = vc.Config(pixflow=vc.PixFlowConfig(ngf=ngf, ndf=ngf,
                                             img_size=size,
                                             batch_size=batch))
    tr = PixFlowTrainer(cfg, device=device)
    state = tr.init_state(0)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    x = torch.rand((batch, size, size, 6), generator=g, device=device)
    m = torch.rand((batch, size, size, 3), generator=g, device=device)
    with tracing.recording() as rec:
        tr.train_step(state, (x, x, m), generator=g)
    summary = rec.summary()
    spans = {s["name"]: s for s in summary["spans"]}
    names = [s["name"] for s in summary["spans"]]
    faults = [n for n in SPANS if names.count(n) != 1]
    if not faults and (spans["vp.train.g_const"]["parent"]
                       != spans["vp.train.d_half"]["id"]):
        faults.append("vp.train.g_const outside vp.train.d_half")
    if faults:
        raise SystemExit("the system's PixFlow trainer does not record "
                         f"what this cell reads: {', '.join(faults)}")


def batches(config: dict, list_path: str, seeds, device, tags):
    """The system's input pipeline, as its trainer CLI builds it: the list
    file's JPEG clips, one ``PixFlowBatcher`` per worker seed in
    ``BackgroundBatches``, ``prefetch_to_device``.  Each batch handed out
    has its (worker, index) appended to ``tags``.  -> (pipeline, the
    device batches)."""
    from voicepuppet_torch.data.generators import (BackgroundBatches,
                                                   FileSource,
                                                   PixFlowBatcher,
                                                   prefetch_to_device)
    cfg = port_config(config, list_path)
    src = FileSource(list_path, cfg, load_images=True)

    def worker(i):
        for j, b in enumerate(PixFlowBatcher(cfg, src, seed=seeds[i])):
            yield tuple(b) + ((i, j),)

    bg = BackgroundBatches(worker, num_workers=len(seeds))

    def untag():
        for item in bg:
            tags.append(item[-1])
            yield item[:-1]

    return bg, prefetch_to_device(untag(), device)
