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
