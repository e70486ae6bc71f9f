"""Shared set-up for the port parity tests (tests/test_torch_*.py): the
small model configuration of tests_tpu/_model_cases.py in both packages,
and JAX parameter trees built once per test process."""

import dataclasses
import functools

import numpy as np


def jax_cfg():
    """ngf 8, 256² PixRefer; width-mult 0.25, 64-wide BFMNet."""
    from voicepuppet_tpu.config import Config
    base = Config()
    return dataclasses.replace(
        base,
        bfmnet=dataclasses.replace(base.bfmnet, backbone_width_mult=0.25,
                                   thinresnet_output_channels=64,
                                   encode_embedding_size=64,
                                   rnn_hidden_size=64),
        pixrefer=dataclasses.replace(base.pixrefer, ngf=8, ndf=8,
                                     img_size=256))


def port_cfg(jcfg=None):
    """The same configuration as the port's own dataclasses."""
    from voicepuppet_torch import config as tc
    jcfg = jcfg or jax_cfg()
    b = jcfg.bfmnet
    return tc.Config(
        model_dir=jcfg.model_dir, frame_rate=jcfg.frame_rate,
        mel=tc.MelConfig(**dataclasses.asdict(jcfg.mel)),
        bfmnet=tc.BFMNetConfig(
            thinresnet_scale=b.thinresnet_scale,
            thinresnet_output_channels=b.thinresnet_output_channels,
            encode_embedding_size=b.encode_embedding_size,
            rnn_hidden_size=b.rnn_hidden_size, rnn_layers=b.rnn_layers,
            bfm_coeff_size=b.bfm_coeff_size,
            backbone_width_mult=b.backbone_width_mult),
        pixrefer=tc.PixReferConfig(ngf=jcfg.pixrefer.ngf,
                                   img_size=jcfg.pixrefer.img_size))


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
