"""Shared set-up for the port parity tests (tests/test_torch_*.py): the
small model configuration of tests_tpu/_model_cases.py in both packages,
and JAX parameter trees built once per test process."""

import dataclasses
import functools

import numpy as np


def jax_cfg():
    """ngf 8, 256² PixRefer; width-mult 0.25, 64-wide BFMNet; PixFlow ngf
    and ndf 8 at 64², batch 2; a 64-wide ATNet (its trunk's width-mult is
    the trainer's argument); VGNet at 32², batch 2."""
    from voicepuppet_tpu.config import Config
    base = Config()
    return dataclasses.replace(
        base,
        bfmnet=dataclasses.replace(base.bfmnet, backbone_width_mult=0.25,
                                   thinresnet_output_channels=64,
                                   encode_embedding_size=64,
                                   rnn_hidden_size=64),
        pixrefer=dataclasses.replace(base.pixrefer, ngf=8, ndf=8,
                                     img_size=256),
        pixflow=dataclasses.replace(base.pixflow, ngf=8, ndf=8, img_size=64,
                                    batch_size=2),
        atnet=dataclasses.replace(base.atnet, thinresnet_output_channels=64,
                                  encode_embedding_size=64,
                                  rnn_hidden_size=64, batch_size=2),
        vgnet=dataclasses.replace(base.vgnet, img_size=32, batch_size=2))


def port_cfg(jcfg=None):
    """The same configuration as the port's own dataclasses: every field
    the port's config keeps, training knobs included."""
    from voicepuppet_torch import config as tc
    jcfg = jcfg or jax_cfg()

    def own(cls, obj):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                v = tc.TrainingConfig(**dataclasses.asdict(v))
            kw[f.name] = v
        return cls(**kw)

    return tc.Config(
        model_dir=jcfg.model_dir, frame_rate=jcfg.frame_rate,
        mel=tc.MelConfig(**dataclasses.asdict(jcfg.mel)),
        training=tc.TrainingConfig(**dataclasses.asdict(jcfg.training)),
        dataset=tc.DatasetConfig(**dataclasses.asdict(jcfg.dataset)),
        bfmnet=own(tc.BFMNetConfig, jcfg.bfmnet),
        pixrefer=own(tc.PixReferConfig, jcfg.pixrefer),
        pixflow=own(tc.PixFlowConfig, jcfg.pixflow),
        atnet=own(tc.ATNetConfig, jcfg.atnet),
        vgnet=own(tc.VGNetConfig, jcfg.vgnet),
        mesh=tc.MeshConfig(**dataclasses.asdict(jcfg.mesh)))


@functools.lru_cache(maxsize=None)
def jax_trees():
    """(bfmnet variables, pixrefer generator params) from the JAX inits,
    as nested dicts of numpy arrays."""
    import jax
    import jax.numpy as jnp
    from voicepuppet_tpu.models import pixrefer as px
    from voicepuppet_tpu.models.bfmnet import BFMNet
    cfg = jax_cfg()
    t = 8
    bfm = BFMNet(cfg.bfmnet).init(
        jax.random.PRNGKey(0), jnp.zeros((1, t, 1)),
        jnp.zeros((1, t * 5, 80)), jnp.full((1,), t, jnp.int32),
        train=False)
    s = cfg.pixrefer.img_size
    x = jnp.zeros((1, s, s, 6))
    # BN means/vars are (0, 1) at init; perturb them so the bridge of
    # batch_stats is actually exercised
    rng = np.random.RandomState(3)
    bfm = jax.tree_util.tree_map(np.asarray, bfm)
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.0, 0.2, a.shape).astype(np.float32),
        bfm["batch_stats"])
    bfm = {"params": bfm["params"], "batch_stats": stats}
    g = px.PixReferNet(cfg.pixrefer).init(jax.random.PRNGKey(1), x, x,
                                          x[..., :3])["params"]
    return bfm, jax.tree_util.tree_map(np.asarray, g)


def numpy_tree(module, *args, seed=0, **kwargs):
    """The variables of ``module.init(key, *args, **kwargs)`` drawn with
    seeded numpy on the shapes of ``jax.eval_shape`` (no XLA compile):
    kernels N(0, 1/fan_in), biases and BN offsets N(0, 0.05), BN scales
    1 + N(0, 0.05), running means U(0, 0.2) and variances 1 + U(0, 0.2)."""
    import jax
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kwargs))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.05 * rng.randn(*shape)).astype(np.float32)
        if name == "mean":
            return rng.uniform(0.0, 0.2, shape).astype(np.float32)
        if name == "var":
            return (1.0 + rng.uniform(0.0, 0.2, shape)).astype(np.float32)
        return (0.05 * rng.randn(*shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- data parallelism: what the spawned ranks of tests/test_torch_parallel.py
# and tests/test_torch_train_dp*.py run (torch and the port only) ----------

DP_LR = 1.0           # SGD at lr 1: a leaf's update is minus its gradient
DP_MOUTH = np.arange(0, 100, 3)
DP_WIDTH = 0.25       # ATNet's trunk width-mult


def _sgd(lr):
    import torch
    return lambda params: torch.optim.SGD(params, lr=lr)


def dp_trainer(name, payload, mesh, default_tx=False):
    """(trainer, state, {module key: module}) of the port's trainer
    ``name`` on the CPU (its ranks' device under ``mesh``), from the JAX
    trees of ``payload``, with dropout off; SGD at ``DP_LR`` unless
    ``default_tx`` (the reference Adams)."""
    from voicepuppet_torch import weights
    cfg, trees = payload["cfg"], payload["trees"]
    tx = None if default_tx else _sgd(DP_LR)
    if name == "bfmnet":
        from voicepuppet_torch.face3d import bfm as tbfm
        from voicepuppet_torch.train.bfmnet_trainer import BFMNetTrainer
        tr = BFMNetTrainer(cfg, tbfm.synthetic_bfm(num_theta=10,
                                                   num_phi=10, seed=0),
                           DP_MOUTH, tx=tx, device="cpu", mesh=mesh)
    elif name == "atnet":
        from voicepuppet_torch.models.atnet import synthetic_pca_component
        from voicepuppet_torch.train.atnet_trainer import ATNetTrainer
        tr = ATNetTrainer(cfg, synthetic_pca_component(6),
                          width_mult=DP_WIDTH, tx=tx, device="cpu",
                          mesh=mesh)
    elif name == "pixrefer":
        from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer
        tr = PixReferTrainer(cfg, g_tx=tx, d_tx=tx, device="cpu", mesh=mesh)
        weights.load_flax_(tr.vgg, trees["vgg"])
    elif name == "pixflow":
        from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
        tr = PixFlowTrainer(cfg, g_tx=tx, d_tx=tx, device="cpu", mesh=mesh)
    elif name == "vgnet":
        from voicepuppet_torch.train.vgnet_trainer import VGNetTrainer
        tr = VGNetTrainer(cfg, alternative=1, g_tx=tx, d_tx=tx,
                          device="cpu", mesh=mesh)
    else:
        raise ValueError(name)
    state = tr.init_state()
    modules = ({"model": state.model} if hasattr(state, "model")
               else {"gen": state.gen, "disc": state.disc})
    for key, module in modules.items():
        weights.load_flax_(module, trees[key])
    if name == "pixflow":
        from voicepuppet_torch.models.pixflow import ResBlock
        for m in state.gen.modules():
            if isinstance(m, ResBlock):
                m.drop_rate = 0.0
    if name == "vgnet":
        state.disc.dis_rnn.drop_rate = 0.0
    return tr, state, modules


def _numpy_state(modules):
    return {key: {k: v.detach().cpu().numpy().copy()
                  for k, v in m.state_dict().items()}
            for key, m in modules.items()}


def dp_run(name, payload, mesh, steps=1, default_tx=False,
           record_local=False):
    """``steps`` train steps of trainer ``name`` on ``payload["batch"]``
    (a global batch; this rank's rows of it, ``shard_batch``, under
    ``mesh``).  Returns per
    step the metrics and every parameter's ``.grad`` (after the gradient
    average; with ``record_local`` also before it), and the final
    parameters and buffers."""
    import sys
    from voicepuppet_torch.parallel import mesh as pm
    tr, state, modules = dp_trainer(name, payload, mesh, default_tx)
    names = {id(p): f"{key}.{n}" for key, m in modules.items()
             for n, p in m.named_parameters()}
    local, averaged = [], []
    mod = sys.modules[type(tr).__module__]
    real = mod.all_reduce_grads_
    if record_local:
        def recording(params, group):
            params = [p for p in params if p.grad is not None]
            for p in params:
                local[-1][names[id(p)]] = p.grad.numpy().copy()
                averaged[-1][names[id(p)]] = (
                    averaged[-1].get(names[id(p)], 0) + 1)
            real(params, group)
        mod.all_reduce_grads_ = recording
    rows = []
    batch = pm.shard_batch(payload["batch"], mesh)
    try:
        for _ in range(steps):
            local.append({})
            averaged.append({})
            state, metrics = tr.train_step(state, batch)
            grads = {names[id(p)]: p.grad.numpy().copy()
                     for m in modules.values() for p in m.parameters()
                     if p.grad is not None}
            rows.append({"metrics": {k: float(v)
                                     for k, v in metrics.items()},
                         "grads": grads, "local": local[-1],
                         "averaged": averaged[-1]})
    finally:
        mod.all_reduce_grads_ = real
    return {"steps": rows, "state": _numpy_state(modules),
            "step": state.step}


def dp_rank_runs(mesh, payloads, steps, tmp):
    """What each rank of the trainer tests' group runs: per trainer one
    SGD run recording the gradients (2 steps for VGNet: its D phase, then
    its G phase) and 3 steps with the reference Adams; then ``dp_fit``."""
    out = {}
    for name, payload in payloads.items():
        out[name] = {
            "sgd": dp_run(name, payload, mesh, steps=steps[name],
                          record_local=True),
            "adam": dp_run(name, payload, mesh, steps=3, default_tx=True)}
    if tmp is not None:
        out["fit"] = dp_fit(mesh, payloads["bfmnet"], tmp)
    return out


def dp_fit(mesh, payload, tmp):
    """BFMNet ``fit`` for 4 steps with an eval and a checkpoint every 2
    and a metrics logger on every rank (``<tmp>/log<rank>``); then every
    rank restores the latest checkpoint into a fresh state."""
    import os
    from voicepuppet_torch.parallel import mesh as pm
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    from voicepuppet_torch.train.metrics import MetricsLogger
    cfg = payload["cfg"]
    b = cfg.bfmnet
    payload = dict(payload, cfg=dataclasses.replace(cfg, bfmnet=(
        dataclasses.replace(b, training=dataclasses.replace(
            b.training, eval_interval=2)))))
    tr, state, modules = dp_trainer("bfmnet", payload, mesh,
                                    default_tx=True)
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"), 5, 2, mesh=mesh)
    logger = MetricsLogger(os.path.join(tmp, f"log{mesh.rank}"), "bfmnet",
                           print_every=0, tensorboard=False)
    evals = []

    def batches(rows):
        while True:
            yield rows

    state = tr.fit(state, batches(pm.shard_batch(payload["batch"], mesh)),
                   4, eval_batches=batches(payload["batch"]),
                   logger=logger, ckpt=ckpt,
                   eval_hook=lambda step, *a: evals.append(step))
    logger.close()
    fresh, _, _ = dp_trainer("bfmnet", payload, mesh, default_tx=True)
    restored = ckpt.restore(fresh.init_state())
    return {"state": _numpy_state(modules),
            "restored": _numpy_state({"model": restored.model}),
            "restored_step": restored.step, "evals": evals}


# ---- data parallelism: the parent side (payloads, JAX 2-device steps,
# gradient bands) --------------------------------------------------------

DP_SIZES = {"bfmnet": (4, 8), "atnet": (2, 4), "vgnet": (2, 4),
            "pixrefer": (2, 256), "pixflow": (2, 64)}
# (rows, T or image size) of each trainer's global batch


def dp_config():
    """``jax_cfg()`` with dropout off in BFMNet and ATNet (the port's and
    JAX's masks cannot match); PixFlow's ResBlocks and VGNet's D GRU are
    switched off by ``dp_trainer`` and ``jax_dp_steps``."""
    cfg = jax_cfg()

    def off(c):
        return dataclasses.replace(c, training=dataclasses.replace(
            c.training, drop_rate=0.0))

    return dataclasses.replace(cfg, bfmnet=off(cfg.bfmnet),
                               atnet=off(cfg.atnet))


def dp_batch(name, seed=5):
    """A numpy-seeded global batch of trainer ``name``; its rows' lengths
    differ, so padded frames enter the batch moments."""
    rng = np.random.RandomState(seed)
    b, t = DP_SIZES[name]
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    if name == "bfmnet":
        return (f32(b, t, 257) * 0.1, rng.rand(b, t, 1).astype(np.float32)
                * 0.1, f32(b, t * 5, 80), np.array([8, 6, 8, 5], np.int32))
    if name == "atnet":
        return (f32(b, t, 136) * 0.1, rng.rand(b, t, 1).astype(np.float32),
                f32(b, t, 3) * 0.1, f32(b, t * 5, 80), f32(b, 136) * 0.1,
                np.array([t, 3], np.int32))
    if name == "vgnet":
        s = 32
        return (f32(b, t, 136) * 0.1,
                rng.rand(b, t, s, s, 1).astype(np.float32),
                rng.rand(b, t, s, s, 3).astype(np.float32),
                f32(b, 136) * 0.1, rng.rand(b, s, s, 3).astype(np.float32),
                np.array([t, 3], np.int32))
    s = t
    if name == "pixrefer":
        return tuple(rng.rand(b, s, s, c).astype(np.float32)
                     for c in (6, 6, 3, 3))
    return (rng.rand(b, s, s, 6).astype(np.float32),
            rng.rand(b, s, s, 6).astype(np.float32),
            (rng.rand(b, s, s, 3) > 0.5).astype(np.float32))


def dp_payload(name):
    """{"cfg": the port's config, "trees": JAX variables per module key
    (seeded numpy on ``jax.eval_shape``), "batch": the global batch,
    "jcfg": the JAX config}."""
    from voicepuppet_tpu.models import atnet as jat
    from voicepuppet_tpu.models import pixflow as jpf
    from voicepuppet_tpu.models import pixrefer as jpx
    from voicepuppet_tpu.models import vgg as jvgg
    from voicepuppet_tpu.models import vgnet as jvg
    from voicepuppet_tpu.models.bfmnet import BFMNet
    jcfg = dp_config()
    batch = dp_batch(name)
    z = lambda *s: np.zeros(s, np.float32)
    if name == "bfmnet":
        t = 8
        trees = {"model": numpy_tree(
            BFMNet(jcfg.bfmnet), z(1, t, 1), z(1, t * 5, 80),
            np.full((1,), t, np.int32), train=False, seed=2)}
    elif name == "atnet":
        trees = {"model": numpy_tree(
            jat.ATNet(jcfg.atnet, jat.synthetic_pca_component(6),
                      width_mult=DP_WIDTH), *batch[1:], train=False,
            seed=1)}
    elif name == "vgnet":
        trees = {"gen": numpy_tree(jvg.VGNetGenerator(jcfg.vgnet),
                                   batch[4], batch[0], batch[3], batch[5],
                                   train=False, seed=4),
                 "disc": numpy_tree(jvg.VGNetDiscriminator(jcfg.vgnet),
                                    batch[2], batch[3], batch[5],
                                    train=False, seed=5)}
    elif name == "pixrefer":
        s = DP_SIZES[name][1]
        trees = {"gen": numpy_tree(jpx.PixReferNet(jcfg.pixrefer),
                                   z(1, s, s, 6), z(1, s, s, 6),
                                   z(1, s, s, 3), seed=1)["params"],
                 "disc": numpy_tree(jpx.Discriminator(jcfg.pixrefer.ndf),
                                    z(1, s, s, 3), z(1, s, s, 3),
                                    seed=2)["params"],
                 "vgg": numpy_tree(jvgg.VGG16Features(), z(1, 32, 32, 3),
                                   seed=3)["params"]}
    else:
        s = DP_SIZES[name][1]
        trees = {"gen": numpy_tree(jpf.PixFlowNet(jcfg.pixflow),
                                   z(1, s, s, 6), z(1, s, s, 6),
                                   train=False, seed=1)["params"],
                 "disc": numpy_tree(jpx.Discriminator(jcfg.pixflow.ndf),
                                    z(1, s, s, 3), z(1, s, s, 3),
                                    seed=2)["params"]}
    return {"cfg": port_cfg(jcfg), "trees": trees, "batch": batch,
            "jcfg": jcfg}


class _EvalApply:
    """A JAX module of a step applied with ``train=False`` (dropout off;
    PixFlow's G and VGNet's D normalize with batch moments either way)."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, *args, train=True, rngs=None, **kw):
        return self.module.apply(variables, *args, train=False, **kw)


def jax_dp_steps(name, payload, steps, devices=2):
    """The JAX trainer's ``steps`` SGD steps at ``DP_LR`` on a
    ``devices``-device mesh from the payload's trees: per step its
    metrics and its gradients (``before - after`` of the leaves it
    updated) under the port's state_dict names, ``<module key>.<name>``,
    and after each step the BN running moments."""
    import jax
    import jax.numpy as jnp
    import optax
    from voicepuppet_tpu.parallel.mesh import make_mesh
    from voicepuppet_tpu.train.state import GANTrainState, TrainState
    from voicepuppet_torch import weights
    jcfg, trees, batch = payload["jcfg"], payload["trees"], payload["batch"]
    mesh = make_mesh(jax.devices()[:devices])
    sgd = optax.sgd(DP_LR)
    _, _, modules = dp_trainer(name, payload, None)
    if name == "bfmnet":
        from voicepuppet_tpu.face3d import bfm as jbfm
        from voicepuppet_tpu.train.bfmnet_trainer import BFMNetTrainer
        jt = BFMNetTrainer(jcfg, jbfm.synthetic_bfm(num_theta=10,
                                                    num_phi=10, seed=0),
                           DP_MOUTH, mesh=mesh, tx=sgd)
        state = TrainState.create(trees["model"]["params"],
                                  trees["model"]["batch_stats"], sgd)
    elif name == "atnet":
        from voicepuppet_tpu.models.atnet import synthetic_pca_component
        from voicepuppet_tpu.train.atnet_trainer import ATNetTrainer
        jt = ATNetTrainer(jcfg, synthetic_pca_component(6), mesh=mesh,
                          width_mult=DP_WIDTH)
        state = TrainState.create(trees["model"]["params"],
                                  trees["model"]["batch_stats"], sgd)
    elif name == "vgnet":
        from voicepuppet_tpu.train.vgnet_trainer import VGNetTrainer
        jt = VGNetTrainer(jcfg, mesh=mesh, alternative=1)
        jt.disc = _EvalApply(jt.disc)
        state = GANTrainState.create(
            trees["gen"]["params"], trees["disc"]["params"],
            batch_stats={"g": trees["gen"]["batch_stats"], "d": {}},
            g_tx=sgd, d_tx=sgd)
    elif name == "pixrefer":
        from voicepuppet_tpu.train.pixrefer_trainer import PixReferTrainer
        jt = PixReferTrainer(jcfg, mesh=mesh, g_tx=sgd, d_tx=sgd)
        jt.vgg_params = jax.tree_util.tree_map(jnp.asarray, trees["vgg"])
        state = GANTrainState.create(trees["gen"], trees["disc"], {}, sgd,
                                     sgd)
    else:
        from voicepuppet_tpu.train.pixflow_trainer import PixFlowTrainer
        jt = PixFlowTrainer(jcfg, mesh=mesh)
        jt.gen = _EvalApply(jt.gen)
        state = GANTrainState.create(trees["gen"], trees["disc"], {}, sgd,
                                     sgd)
    extra = ({"log_gradients": False} if name in ("atnet", "pixflow")
             else {})
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)

    def named(st):
        if hasattr(st, "params"):
            trees_ = {"model": {"params": st.params,
                                "batch_stats": st.batch_stats}}
        else:
            gs = (st.batch_stats.get("g", {}) if st.batch_stats else {})
            trees_ = {"gen": ({"params": st.g_params, "batch_stats": gs}
                              if gs else {"params": st.g_params}),
                      "disc": {"params": st.d_params}}
        out = {}
        for key, tree in trees_.items():
            sd = weights.state_dict_from_flax(host(tree), modules[key])
            out.update({f"{key}.{k}": v.numpy() for k, v in sd.items()})
        return out

    rows = []
    before = named(state)
    for i in range(steps):
        state, metrics = jt.train_step(state, batch,
                                       jax.random.PRNGKey(i), **extra)
        after = named(state)
        rows.append({"metrics": {k: float(v) for k, v in metrics.items()
                                 if not k.startswith("_")},
                     "grads": {k: (before[k] - after[k]) / DP_LR
                               for k in after if not k.endswith(
                                   ("running_mean", "running_var"))
                               and not np.array_equal(before[k],
                                                      after[k])},
                     "moments": {k: v for k, v in after.items()
                                 if k.endswith(("running_mean",
                                                "running_var"))}})
        before = after
    return rows


def grad_bands(got, want, trunk, head_band=1e-4, trunk_band=0.15,
               trunk_l2=2e-2, null_grad=1e-4):
    """The rows that break the bands, comparing gradients ``got`` with
    ``want`` (dicts over the leaves of ``want``): a leaf matching the
    regex ``trunk`` (None: no leaf; behind stacked train-mode batch norms, where float32
    backward is ill-conditioned) within ``trunk_band`` of its max |g| and
    all of them within ``trunk_l2`` in relative L2; any other leaf within
    ``head_band`` of its max |g|; a leaf whose true gradient is zero (a
    shift that a following batch norm removes: |g| below ``null_grad``
    on the reference) held by magnitude."""
    import re
    bad, dt, wt = [], [], []
    for k, w in want.items():
        g = got[k]
        scale = float(np.abs(w).max())
        if scale < null_grad:
            if not np.abs(g).max() < null_grad:
                bad.append((k, "null", float(np.abs(g).max())))
            continue
        err = float(np.abs(g - w).max()) / scale
        if trunk is not None and re.search(trunk, k):
            dt.append((g - w).ravel())
            wt.append(w.ravel())
            if not err < trunk_band:
                bad.append((k, "trunk", err))
        elif not err < head_band:
            bad.append((k, "head", err))
    if dt:
        l2 = float(np.linalg.norm(np.concatenate(dt))
                   / np.linalg.norm(np.concatenate(wt)))
        if not l2 < trunk_l2:
            bad.append(("trunk L2", l2))
    return bad


def dp_rank(ranks, name, run="sgd", rank=0):
    """One rank's result of ``dp_rank_runs`` for trainer ``name``."""
    return ranks[rank][name][run]


def check_dp_losses(ranks, single, jax2, name, loss_rel=1e-4):
    """The losses of every step, averaged over the ranks, against the
    single-process step and the JAX 2-device step (``grad_norm`` is a norm
    over the trunk's gradients too and is held by the gradient bands)."""
    for i, row in enumerate(dp_rank(ranks, name)["steps"]):
        for k, want in jax2[name][i]["metrics"].items():
            if k == "grad_norm":
                continue
            got = row["metrics"][k]
            one = single[name]["steps"][i]["metrics"][k]
            assert abs(got - want) <= loss_rel * abs(want), (k, got, want)
            assert abs(got - one) <= loss_rel * abs(one), (k, got, one)


def check_dp_grads(ranks, single, jax2, name, ref, trunk):
    """Every step's averaged gradients within ``grad_bands`` of the
    single-process step's (``ref`` "single") or the JAX 2-device step's."""
    for i, row in enumerate(dp_rank(ranks, name)["steps"]):
        want = jax2[name][i]["grads"]
        if ref == "single":
            own = single[name]["steps"][i]["grads"]
            want = {k: own[k] for k in want}
        assert want
        bad = grad_bands(row["grads"], want, trunk)
        assert not bad, (i, bad[:5])


def check_wrong_reduction(ranks, single, name, control, trunk):
    """Twice or half the averaged gradients, or a rank's own gradients
    before the average, break the bands that the true ones sit in."""
    for i, row in enumerate(dp_rank(ranks, name)["steps"]):
        want = single[name]["steps"][i]["grads"]
        if control == "no_average":
            got = row["local"]
        else:
            f = 2.0 if control == "twice" else 0.5
            got = {k: f * v for k, v in row["grads"].items()}
        want = {k: want[k] for k in got if k in want}
        assert want
        assert grad_bands(got, want, trunk)


def check_ranks_identical(ranks, name):
    """After three Adam steps and the SGD steps, both ranks hold the same
    parameters and buffers, metrics and averaged gradients, to the bit
    (while their gradients before the average differ)."""
    for run in ("adam", "sgd"):
        a, b = dp_rank(ranks, name, run, 0), dp_rank(ranks, name, run, 1)
        assert a["step"] == b["step"]
        for m, sd in a["state"].items():
            for k, v in sd.items():
                assert np.array_equal(v, b["state"][m][k]), (run, m, k)
    for ra, rb in zip(dp_rank(ranks, name)["steps"],
                      dp_rank(ranks, name, rank=1)["steps"]):
        assert ra["metrics"] == rb["metrics"]
        for k, v in ra["grads"].items():
            assert np.array_equal(v, rb["grads"][k]), k
        assert any(not np.array_equal(v, rb["local"][k])
                   for k, v in ra["local"].items())


# ---- data parallelism: the layer itself (tests/test_torch_parallel.py) ----

BN_FORMS = ("tfbn", "stateless", "center")


def bn_module(form, ch, seed=0):
    """One of the port's three batch-moment norms with seeded offsets (and
    scales): ``layers.TFBatchNorm`` (train mode), ``pixrefer.
    StatelessBatchNorm``, ``vgnet.StatelessCenterBN``."""
    import torch
    from voicepuppet_torch.models import layers, pixrefer, vgnet
    m = {"tfbn": layers.TFBatchNorm, "stateless": pixrefer.StatelessBatchNorm,
         "center": vgnet.StatelessCenterBN}[form](ch)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return m


def bn_case(form, x, r, group=None):
    """Forward ``x`` through a fresh ``bn_module(form)`` (train mode) with
    its moments over ``group``, back-propagate ``sum(y * r)``; returns
    numpy (y, dx, {param: grad}, {buffer: value})."""
    import torch
    from voicepuppet_torch.models.layers import sync_bn
    m = bn_module(form, x.shape[1])
    xt = torch.tensor(x, requires_grad=True)
    with sync_bn(group, m):
        y = m(xt, True) if form == "tfbn" else m(xt)
    (y * torch.as_tensor(r)).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(),
            {n: p.grad.numpy() for n, p in m.named_parameters()},
            {n: b.numpy().copy() for n, b in m.named_buffers()})


def parallel_rank_checks(mesh, x, r):
    """What each rank of test_torch_parallel.py's group computes, on its
    rows of the global ``x`` [B, C, H, W] and cotangent weights ``r``."""
    import torch
    import torch.distributed as dist
    from voicepuppet_torch.models.layers import batch_moments, dropout
    from voicepuppet_torch.parallel import mesh as pm
    rows = pm.local_batch_rows(x.shape[0], mesh)
    xs, rs = pm.rank_rows((x, r), mesh)
    out = {"rank": mesh.rank, "world": mesh.world, "rows": rows,
           "device": str(mesh.device)}
    mean, var = batch_moments(torch.as_tensor(xs), mesh.group)
    out["moments"] = (mean.numpy(), var.numpy())
    out["bn"] = {f: bn_case(f, xs, rs, mesh.group) for f in BN_FORMS}
    # params averaged as the trainers average them
    for f in BN_FORMS:
        grads = out["bn"][f][2]
        ts = {n: torch.as_tensor(g).clone() for n, g in grads.items()}
        params = []
        for n, t in ts.items():
            p = torch.nn.Parameter(torch.zeros_like(t))
            p.grad = t
            params.append((n, p))
        pm.all_reduce_grads_([p for _, p in params], mesh.group)
        out.setdefault("averaged", {})[f] = {n: p.grad.numpy()
                                             for n, p in params}
    # AllReduceSum: y = sum_ranks(c x); the backward sums the cotangents
    c = float(mesh.rank + 2)
    xa = torch.arange(4.0, requires_grad=True)
    v = torch.full((4,), float(3 * mesh.rank + 1))
    y = pm.AllReduceSum.apply(c * xa, mesh.group)
    (y * v).sum().backward()
    out["allreduce"] = (y.detach().numpy(), xa.grad.numpy(), c)
    # dropout masks from each rank's generator
    gen = pm.rank_generator(0, mesh.rank)
    out["mask"] = dropout(torch.ones(64), 0.5, gen).numpy()
    out["metric"] = float(pm.pmean_metric(torch.tensor(float(mesh.rank)),
                                          mesh))
    # replicate: rank 1 starts elsewhere, both end at rank 0's numbers
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(mesh.rank))
    pm.replicate([lin], mesh)
    out["replicated"] = lin.weight.detach().numpy().copy()
    # a group of one rank (each rank its own) against no group at all
    solo = [dist.new_group([k]) for k in range(mesh.world)][mesh.rank]
    out["solo"] = {f: (bn_case(f, xs, rs, solo), bn_case(f, xs, rs, None))
                   for f in BN_FORMS}
    g = torch.randn(5, generator=torch.Generator().manual_seed(1))
    p = torch.nn.Parameter(torch.zeros(5))
    p.grad = g.clone()
    pm.all_reduce_grads_([p], solo)
    out["solo_grads"] = (p.grad.numpy(), g.numpy())
    # the per-rank feed: local rows land on the device untouched
    local = pm.shard_batch_local(pm.rank_rows((x,), mesh), mesh)
    out["local_is_rows"] = bool(np.array_equal(local[0].numpy(), xs))
    return out


# ---- sharded serving (tests/test_torch_synthesize_sharded.py) ----

SHARD_S = 256           # jax_cfg's PixRefer size
SHARD_BFM = (16, 16, 1)  # synthetic_bfm(num_theta, num_phi, seed)


def sharded_synth(mesh, states, partition, chunk, **kw):
    """The port's Synthesizer at ``port_cfg()`` over ``mesh`` (float32 G,
    rgb8, ``raster_bb`` 24 as the JAX reference renders), from numpy
    state_dicts."""
    import torch
    from voicepuppet_torch.face3d import bfm
    from voicepuppet_torch.pipeline import synthesize as tsyn
    bfm_state, g_state = ({k: torch.as_tensor(v) for k, v in s.items()}
                          for s in states)
    model = bfm.synthetic_bfm(num_theta=SHARD_BFM[0],
                              num_phi=SHARD_BFM[1], seed=SHARD_BFM[2])
    return tsyn.Synthesizer(port_cfg(), model, bfm_state, g_state,
                            chunk=chunk, mesh=mesh,
                            mesh_partition=partition, raster_bb=24,
                            gan_dtype=torch.float32, transfer_format="rgb8",
                            device="cpu", **kw)


def sharded_serving_rank(mesh, states, cases, units):
    """What each rank of test_torch_synthesize_sharded.py's groups
    computes: ``cases`` {name: (partition, chunk, kind, args)} rendered
    by a sharded Synthesizer (``kind`` "render": render_frames(coeff,
    identity, ref, fg, bgs); "stream": a StreamingSynthesizer fed pcm in
    pieces, then flushed), each with synth.chunk and K1's call count;
    ``units``: (x [B,C,H,W], the state_dicts of a GenConv and a
    GenDeconv) for the halo and BN unit checks, or None."""
    import torch
    from voicepuppet_torch.models import pixrefer as px
    from voicepuppet_torch.parallel import spatial
    from voicepuppet_torch.pipeline import streaming, synthesize as tsyn
    out = {"rank": mesh.rank}
    for name, (partition, chunk, kind, args) in cases.items():
        synth = sharded_synth(mesh, states, partition, chunk)
        ident = tsyn.synthetic_identity(synth.face_model, 0, SHARD_S)
        calls = []
        real = tsyn.render_colors_auto

        def counted(verts, *a, **k):
            calls.append(int(verts.shape[0]))
            return real(verts, *a, **k)

        tsyn.render_colors_auto = counted
        try:
            if kind == "render":
                coeff, ref, fg, bgs = args
                got = synth.render_frames(coeff, ident, ref, fg, bgs)
            else:
                pcm, ref, fg, step = args
                ss = streaming.StreamingSynthesizer(synth, ident, ref, fg)
                blocks = []
                for i in range(0, pcm.shape[0], step):
                    blocks += ss.feed(pcm[i:i + step])
                blocks += ss.flush()
                got = blocks
        finally:
            tsyn.render_colors_auto = real
        out[name] = {"frames": got, "chunk": synth.chunk, "k1": calls}
    if units is not None:
        x, conv_state, deconv_state = units
        sp = spatial.RowSplit(mesh.group)
        xt = torch.as_tensor(x)
        conv = px.GenConv(x.shape[1], conv_state["Conv_0.weight"].shape[0])
        conv.load_state_dict({k: torch.as_tensor(v)
                              for k, v in conv_state.items()})
        deconv = px.GenDeconv(x.shape[1],
                              deconv_state["ConvTranspose_0.weight"].shape[1])
        deconv.load_state_dict({k: torch.as_tensor(v)
                                for k, v in deconv_state.items()})
        bn = px.StatelessBatchNorm(x.shape[1])
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
        part = spatial.Part(sp.take(xt), True)
        with torch.inference_mode():
            out["conv_rows"] = sp.conv(conv, part).t.numpy()
            out["deconv_rows"] = sp.conv(deconv, part).t.numpy()
            out["moments"] = sp.moments(part.t).numpy()
            out["bn_rows"] = sp.bn(bn, part).t.numpy()
    return out


def histogram_rank(mesh, cfg, component, batch, log_dir):
    """One rank of an ATNet fit with gradient histograms at interval 1:
    every rank passes its own logger (``<log_dir>/rank<r>``), the fit
    logs on rank 0 alone.  Returns the rank's flat averaged gradient."""
    import os
    import torch
    from voicepuppet_torch.parallel.mesh import shard_batch
    from voicepuppet_torch.train.atnet_trainer import ATNetTrainer
    from voicepuppet_torch.train.metrics import MetricsLogger
    logger = MetricsLogger(os.path.join(log_dir, f"rank{mesh.rank}"),
                           "atnet", print_every=0, histogram_interval=1)
    tr = ATNetTrainer(cfg, component, width_mult=DP_WIDTH, mesh=mesh)
    state = tr.fit(tr.init_state(), iter([shard_batch(batch, mesh)]), 1,
                   logger)
    logger.close()
    return torch.cat([p.grad.reshape(-1) for p in state.model.parameters()
                      if p.grad is not None]).numpy()
