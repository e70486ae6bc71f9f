"""The port's graft entry points (``voicepuppet_torch/graft_entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU.

``entry()``'s frame step is held against the JAX frame step on the same
example arguments and the same generator weights (the port's seed-0
weights carried into a JAX tree by ``weights.flax_from_state_dict``).
``Config()`` width (ngf 64 at 512²) is too large to run here, so both
steps run at the tests' small widths (ngf 8 at 256²): the port's
``entry(cfg=...)`` against a JAX step written as ``__graft_entry__.py:
38-55`` writes it, calling the same JAX modules at that ``cfg``.  Both
sides are float32 and the generators sum in other orders: on the
example arguments the raster is bit-equal (``bb`` 12 holds this mesh's
triangles) and the frames, values in [0, 1], differ by at most 7.6e-5
(band FRAME_ATOL).  Random head angles decode vertices ~3e-5 px apart,
which may flip a borderline raster pixel that the U-Net spreads (max
2.8e-3, mean 2.1e-5): those are held in 8-bit codes to
``tests/test_torch_synthesize.py``'s bands, mean |diff| under MEAN_BAND
and the share over one code under OVER_ONE_BAND (measured 5.5e-3
codes and 0).

``Synthesizer.frame_program_for(entry_identity())`` at float32 gives the
entry's frames byte for byte, on the example arguments and on random
ones.  ``dryrun_multichip(2, device="cpu")`` runs its two gloo ranks on
the CPU and prints its OK line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.face3d import morph as jmorph
from voicepuppet_tpu.models import pixrefer as jpx
from voicepuppet_tpu.ops import render_colors_auto as jrender

from voicepuppet_torch import graft_entry, weights

from _torch_port_cases import jax_cfg, port_cfg

torch.set_num_threads(1)

FRAME_ATOL = 2e-4
MEAN_BAND = 0.01        # mean |diff| in 8-bit codes
OVER_ONE_BAND = 1e-3    # share of values more than one code apart


def _jax_frame_step(cfg, g_params):
    """``__graft_entry__.py:38-55`` at ``cfg``, jitted."""
    face_model = jbfm.synthetic_bfm(num_theta=graft_entry.ENTRY_GRID,
                                    num_phi=graft_entry.ENTRY_GRID, seed=0)
    fm = jmorph.device_bfm(face_model)
    s = cfg.pixrefer.img_size
    gen = jpx.PixReferNet(cfg.pixrefer)
    c = graft_entry.ENTRY_CHUNK

    @jax.jit
    def frame_step(coeff, angles, background, face3d_ref, fg_ref):
        rec = jmorph.reconstruct_rotation(coeff, fm, angles)
        verts = jnp.concatenate([rec.face_projection, rec.z_buffer], -1)
        colors = jnp.floor(jnp.clip(rec.face_color, 0.0, 255.0))
        img224, _ = jrender(verts, colors, fm.tri, h=224, w=224, bb=12)
        face = jax.image.resize(img224.astype(jnp.float32) / 255.0,
                                (c, s, s, 3), method="linear")
        ref = jnp.broadcast_to(face3d_ref[None], (c, s, s, 3))
        inputs = jnp.concatenate([ref, face], -1)
        fg_in = jnp.concatenate(
            [jnp.broadcast_to(fg_ref[None], (c, s, s, 3)),
             jnp.zeros((c, s, s, 3))], -1)
        outputs, _, _ = gen.apply({"params": g_params},
                                  jpx.preprocess(inputs),
                                  jpx.preprocess(fg_in),
                                  jpx.preprocess(background))
        return jpx.deprocess(outputs)

    coeff = jbfm.demo_coeff(face_model, batch=c)
    return frame_step, coeff


@pytest.fixture(scope="module")
def steps():
    jcfg = jax_cfg()
    frame_step, args = graft_entry.entry(device="cpu", cfg=port_cfg(jcfg))
    gen = args[0]
    s = jcfg.pixrefer.img_size
    x = jnp.zeros((1, s, s, 6))
    template = jax.eval_shape(lambda: jpx.PixReferNet(jcfg.pixrefer).init(
        jax.random.PRNGKey(0), x, x, x[..., :3]))["params"]
    g_params = weights.flax_from_state_dict(gen.state_dict(), template,
                                            gen)
    jstep, jcoeff = _jax_frame_step(jcfg, g_params)
    return frame_step, args, jstep, jcoeff


def test_entry_example_args(steps):
    """The JAX entry's example arguments: its demo coefficients for 4
    frames, zero angles, backgrounds and references."""
    _, args, _, jcoeff = steps
    gen, coeff, angles, bg, face3d_ref, fg_ref = args
    s = port_cfg().pixrefer.img_size
    np.testing.assert_array_equal(coeff.numpy(), jcoeff)
    assert angles.shape == (4, 3) and bg.shape == (4, s, s, 3)
    assert face3d_ref.shape == fg_ref.shape == (s, s, 3)
    assert next(gen.parameters()).dtype == torch.float32


@pytest.mark.parametrize("inputs", ["example", "random"])
def test_entry_frame_step_matches_jax(steps, inputs):
    """The frame step on the example arguments, and on random angles,
    background and references, against the JAX step."""
    frame_step, args, jstep, _ = steps
    args = list(args)
    if inputs == "random":
        rng = np.random.RandomState(7)
        args[2:] = [torch.from_numpy(rng.uniform(
            -0.2, 0.2, tuple(a.shape)).astype(np.float32)) if i == 0
            else torch.from_numpy(rng.rand(*a.shape).astype(np.float32))
            for i, a in enumerate(args[2:])]
    got = frame_step(*args).numpy()
    want = np.asarray(jstep(*(jnp.asarray(a.numpy()) for a in args[1:])))
    assert got.shape == want.shape == (4, 256, 256, 3)
    d = np.abs(got - want)
    if inputs == "example":
        assert d.max() < FRAME_ATOL, d.max()
    assert d.mean() * 255 < MEAN_BAND, d.mean() * 255
    assert (d * 255 > 1).mean() < OVER_ONE_BAND, (d * 255 > 1).mean()
    assert got.std() > 0


@pytest.mark.parametrize("inputs", ["example", "random"])
def test_entry_step_is_the_synthesizer_frame_program(steps, inputs):
    """``Synthesizer.frame_program_for(entry_identity())`` at float32 and
    ``rgb8`` on the entry's arguments and generator weights gives the
    entry's frames as uint8, byte for byte (the card holds them to
    ``chip_smoke.ENTRY_MEAN_CODES``)."""
    from voicepuppet_torch.face3d import bfm as tbfm
    from voicepuppet_torch.pipeline import synthesize as tsyn
    frame_step, args, _, _ = steps
    cfg = port_cfg()
    gen, coeff, angles, bg, face3d_ref, fg_ref = args
    if inputs == "random":
        rng = np.random.RandomState(7)
        angles, bg, face3d_ref, fg_ref = [
            torch.from_numpy(rng.uniform(-0.2, 0.2, tuple(a.shape)).astype(
                np.float32)) if i == 0
            else torch.from_numpy(rng.rand(*a.shape).astype(np.float32))
            for i, a in enumerate((angles, bg, face3d_ref, fg_ref))]
    got = frame_step(gen, coeff, angles, bg, face3d_ref, fg_ref)
    face_model = tbfm.synthetic_bfm(num_theta=graft_entry.ENTRY_GRID,
                                    num_phi=graft_entry.ENTRY_GRID, seed=0)
    bfm_state, _ = tsyn.SynthesisAssets.init_trees(cfg, 0)
    synth = tsyn.Synthesizer(cfg, face_model, bfm_state, gen.state_dict(),
                             chunk=graft_entry.ENTRY_CHUNK,
                             gan_dtype=torch.float32,
                             transfer_format="rgb8", device="cpu")
    with torch.inference_mode():
        want = synth.frame_program_for(graft_entry.entry_identity(cfg))(
            coeff, angles, bg, torch.arange(coeff.shape[0]), face3d_ref,
            fg_ref)
    synth.close()
    assert want.dtype == torch.uint8 and want.shape == got.shape
    torch.testing.assert_close(
        torch.clamp(got * 255.0, 0, 255).to(torch.uint8), want, rtol=0,
        atol=0)


def test_dryrun_multichip_prints_ok(capsys):
    graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert out[0].startswith("dryrun_multichip(2): bfmnet loss ")
    assert "frame-sharded inference (2, 256, 256, 3)" in out[0]
    assert "spatial-GAN rows (2, 128, 256, 4)" in out[0]
    assert out[0].endswith("— OK")
