"""The graft entry points of the port (counterpart of the JAX package's root
``__graft_entry__.py``, which stays the JAX package's).

``entry()`` returns the frame step of the serving path at ``Config()``
width (3DMM decode -> flat colours -> the raster K1 at 224² -> linear
resize to 512² -> PixRefer G -> deprocess) with example arguments;
``dryrun_multichip(n)`` runs one data-parallel training step of BFMNet
and of the PixRefer GAN, a frames-sharded Synthesizer call and a
row-split generator forward on ``n`` spawned ranks at tiny widths.
A script that calls ``dryrun_multichip`` needs an ``if __name__ ==
"__main__"`` guard: the ranks are spawned processes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ENTRY_CHUNK = 4     # frames per step
ENTRY_GRID = 48     # synthetic_bfm(48, 48): 4,418 triangles
RASTER_SIZE = 224


def entry(device="cuda", cfg=None):
    """(frame_step, example_args) at ``cfg`` (default ``Config()``: ngf
    64 at 512²), ``ENTRY_CHUNK`` frames, on ``synthetic_bfm(48, 48)``
    with the generator's weights from seed 0 (float32, as the JAX
    entry's).  ``frame_step(gen, coeff [C,257], angles [C,3], background
    [C,S,S,3], face3d_ref [S,S,3], fg_ref [S,S,3])`` -> frames [C,S,S,3]
    float32 in [0, 1] (``__graft_entry__.py:38-55``); on the card the
    raster is K1."""
    from voicepuppet_torch.audio.frontend import full_fp32_matmuls
    from voicepuppet_torch.config import Config
    from voicepuppet_torch.face3d import bfm, morph
    from voicepuppet_torch.models import pixrefer as px
    from voicepuppet_torch.ops import render_colors_auto
    from voicepuppet_torch.pipeline.synthesize import resize_linear

    cfg = cfg or Config()
    dev = torch.device(device)
    full_fp32_matmuls()
    face_model = bfm.synthetic_bfm(num_theta=ENTRY_GRID, num_phi=ENTRY_GRID,
                                   seed=0)
    fm = morph.device_bfm(face_model, dev)
    s = cfg.pixrefer.img_size
    gen = px.init_pixrefer_(px.PixReferNet(cfg.pixrefer),
                            torch.Generator().manual_seed(0)).to(dev)
    c = ENTRY_CHUNK

    @torch.no_grad()
    def frame_step(gen, coeff, angles, background, face3d_ref, fg_ref):
        rec = morph.reconstruct_rotation(coeff, fm, angles)
        verts = torch.cat([rec.face_projection, rec.z_buffer],
                          -1).contiguous()
        colors = torch.floor(torch.clamp(rec.face_color, 0.0,
                                         255.0)).contiguous()
        img, _ = render_colors_auto(verts, colors, fm.tri, h=RASTER_SIZE,
                                    w=RASTER_SIZE, bb=12)
        face = resize_linear(img.float() / 255.0, s)
        ref = face3d_ref[None].expand(c, -1, -1, -1)
        inputs = torch.cat([ref, face], -1)
        fg_in = torch.cat([fg_ref[None].expand(c, -1, -1, -1),
                           torch.zeros_like(ref)], -1)
        outputs, _, _ = gen(px.preprocess(inputs), px.preprocess(fg_in),
                            px.preprocess(background))
        return px.deprocess(outputs)

    coeff = torch.as_tensor(bfm.demo_coeff(face_model, batch=c),
                            dtype=torch.float32, device=dev)
    zeros = lambda *shape: torch.zeros(shape, device=dev)
    example_args = (gen, coeff, zeros(c, 3), zeros(c, s, s, 3),
                    zeros(s, s, 3), zeros(s, s, 3))
    return frame_step, example_args


def entry_identity(cfg=None):
    """The identity under which ``Synthesizer.frame_program_for`` computes
    :func:`entry`'s frame step (``cfg`` default ``Config()``): the 224²
    render resized to the whole S² frame and pasted at its origin, RGB
    colours.  The program's coefficients come from its caller, so the
    identity's own are zeros."""
    from voicepuppet_torch.config import Config
    from voicepuppet_torch.pipeline.synthesize import Identity
    s = (cfg or Config()).pixrefer.img_size
    return Identity(bfmcoeff=np.zeros((1, 257), np.float32),
                    transform_params=np.array([s, s, RASTER_SIZE / s, 0.0,
                                               0.0]),
                    center_x=s // 2, center_y=s // 2, ratio=1.0)


def dryrun_config(n: int):
    """``__graft_entry__.py:101-113``'s widths: BFMNet width 0.25, 32
    wide, dropout 0.25, lr 1e-4; PixRefer ngf and ndf 4 at 256²; both at
    a global batch of ``n``."""
    from voicepuppet_torch.config import Config, TrainingConfig
    base = Config()
    return dataclasses.replace(
        base,
        bfmnet=dataclasses.replace(
            base.bfmnet, batch_size=n, backbone_width_mult=0.25,
            thinresnet_output_channels=32, encode_embedding_size=32,
            rnn_hidden_size=32,
            training=TrainingConfig(learning_rate=1e-4, drop_rate=0.25)),
        pixrefer=dataclasses.replace(base.pixrefer, ngf=4, ndf=4,
                                     img_size=256, batch_size=n))


def _finite(x, what):
    x = np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x)
    if not np.isfinite(x).all():
        raise AssertionError(f"{what}: not finite")


def _dryrun_rank(mesh, n: int) -> dict:
    """One rank of :func:`dryrun_multichip`: its losses and the shapes it
    served (frames None off rank 0)."""
    from voicepuppet_torch.face3d import bfm
    from voicepuppet_torch.parallel.mesh import rank_generator, shard_batch
    from voicepuppet_torch.parallel.spatial import generator_rows
    from voicepuppet_torch.pipeline import synthesize as syn
    from voicepuppet_torch.train.bfmnet_trainer import BFMNetTrainer
    from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer

    cfg = dryrun_config(n)
    dev = mesh.device

    # BFMNet: one data-parallel step (sync-BN, one gradient all-reduce),
    # then two more in one train_multi_step call
    face_model = bfm.synthetic_bfm(num_theta=8, num_phi=8, seed=0)
    trainer = BFMNetTrainer(cfg, face_model, mesh=mesh)
    state = trainer.init_state()
    rng = np.random.RandomState(0)
    t = 4
    batch = (rng.randn(n, t, 257).astype(np.float32),
             rng.rand(n, t, 1).astype(np.float32),
             rng.randn(n, t * 5, 80).astype(np.float32),
             np.full((n,), t, np.int32))
    local = shard_batch(batch, mesh)
    gen = rank_generator(0, mesh.rank, dev)
    state, metrics = trainer.train_step(state, local, gen)
    if state.step != 1:
        raise AssertionError(f"bfmnet step {state.step}, not 1")
    _finite(metrics["loss"], "bfmnet loss")
    state, stacked = trainer.train_multi_step(state, [local, local], gen)
    if state.step != 3 or tuple(stacked["loss"].shape) != (2,):
        raise AssertionError(f"bfmnet multi-step: step {state.step}, "
                             f"losses {tuple(stacked['loss'].shape)}")
    _finite(stacked["loss"], "bfmnet multi-step losses")

    # PixRefer GAN: one D-then-G step
    s = cfg.pixrefer.img_size
    gan = PixReferTrainer(cfg, mesh=mesh)
    gstate = gan.init_state()
    gbatch = (rng.rand(n, s, s, 6).astype(np.float32),
              rng.rand(n, s, s, 6).astype(np.float32),
              rng.rand(n, s, s, 3).astype(np.float32),
              (rng.rand(n, s, s, 3) > 0.5).astype(np.float32))
    gstate, gmetrics = gan.train_step(gstate, shard_batch(gbatch, mesh))
    if gstate.step != 2:
        raise AssertionError(f"pixrefer step {gstate.step}, not 2")
    _finite(gmetrics["gen_loss"], "pixrefer gen_loss")

    # frames-sharded serving of n frames with the trained weights: each
    # rank decodes, rasterizes and generates its rows; rank 0 gets them
    with syn.Synthesizer(cfg, face_model, state.model.state_dict(),
                         gstate.gen.state_dict(), chunk=n, mesh=mesh,
                         mesh_partition="frames",
                         gan_dtype=torch.float32) as synth:
        ident = syn.synthetic_identity(face_model, 0, s)
        coeff = bfm.demo_coeff(face_model, batch=n)
        ref = np.zeros((s, s, 3), np.float32)
        frames = synth.render_frames(coeff, ident, ref, ref,
                                     np.zeros((1, s, s, 3), np.float32),
                                     angles=np.zeros((n, 3), np.float32))
    want = (n, s, s, 3) if mesh.is_main else None
    if getattr(frames, "shape", None) != want:
        raise AssertionError(f"rank {mesh.rank}: sharded frames "
                             f"{getattr(frames, 'shape', None)}, not {want}")

    # the generator's height split over the ranks (spatial partition)
    rng2 = np.random.RandomState(1)
    sp_in = torch.as_tensor(rng2.rand(2, s, s, 6).astype(np.float32),
                            device=dev)
    sp_fg = torch.as_tensor(rng2.rand(2, s, s, 6).astype(np.float32),
                            device=dev)
    with torch.no_grad():
        rows = generator_rows(gstate.gen.generator, sp_in, sp_fg[..., :3],
                              mesh.group)
    if tuple(rows.shape) != (2, s // mesh.world, s, 4):
        raise AssertionError(f"spatial rows {tuple(rows.shape)}")
    _finite(rows, "spatial rows")
    return {"bfmnet_loss": float(metrics["loss"]),
            "gen_loss": float(gmetrics["gen_loss"]),
            "frames": None if frames is None else frames.shape,
            "rows": tuple(rows.shape)}


def dryrun_multichip(n: int, device="cuda") -> None:
    """``__graft_entry__.dryrun_multichip(n)``'s checks on ``n`` spawned
    ranks of one gloo group (``parallel.spawn.run_ranks``) on ``device``:
    every rank on one card (``cuda``, the default; no card raises), or
    the CPU when the caller asks for it.  Each rank asserts shapes, steps
    and finite values; a rank that fails raises here.  Prints rank 0's
    OK line."""
    from voicepuppet_torch.parallel.spawn import run_ranks
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (pass "
                           "device=\"cpu\" for a CPU run)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    r0 = run_ranks(_dryrun_rank, n, n, device=str(dev), backend="gloo")[0]
    print(f"dryrun_multichip({n}): bfmnet loss {r0['bfmnet_loss']:.3f}, "
          f"pixrefer gen_loss {r0['gen_loss']:.3f}, frame-sharded "
          f"inference {r0['frames']}, spatial-GAN rows {r0['rows']} "
          f"per rank — OK", flush=True)

