"""Sharded serving of the port (``Synthesizer(mesh=, mesh_partition=)``,
``parallel/spatial.py``) against the port's single-process Synthesizer
and the JAX single-device Synthesizer on the same weights (seeded numpy
trees on the JAX modules' shapes, bridged by voicepuppet_torch/weights.py),
all on the CPU.  Rank groups are spawned by ``parallel.spawn.run_ranks``
(gloo, one thread a rank): world 2 (both partitions, a spatial stream,
the halo and BN units), world 3 (a frames tail bucket that differs from
the single-process one) and world 4 (spatial, with whole deep levels).

Bands: frames to +-1 uint8 with under 5% of values differing, the JAX
package's own sharded-vs-single bound (tests/test_pipeline.py:195, 320);
float32 generator and rgb8 on every side, as those tests use.  The halo
conv and deconv rows equal the unsplit conv's to the bit on the CPU (each
output row sums the same products in the same order); the sharded BN
moments, float64 sums of the float32 values and squares, equal the
float64 moments of the whole tensor to 1e-12 relative.  The JAX sharded
Synthesizer itself is not run here (a 2-device CPU compile of each
partition costs minutes); the JAX package's tests at test_pipeline.py:195
and :320 hold it to its single-device frames.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicepuppet_tpu.models import pixrefer as jpx
from voicepuppet_tpu.models.bfmnet import BFMNet as JBFMNet
from voicepuppet_tpu.parallel import mesh as jmesh
from voicepuppet_tpu.pipeline import synthesize as jsyn

from voicepuppet_torch import weights
from voicepuppet_torch.face3d import bfm as tbfm
from voicepuppet_torch.models import pixrefer as px
from voicepuppet_torch.parallel import mesh as pm
from voicepuppet_torch.parallel.spawn import run_ranks
from voicepuppet_torch.pipeline import streaming as tstream
from voicepuppet_torch.pipeline import synthesize as tsyn

from _torch_port_cases import (SHARD_BFM, SHARD_S, jax_cfg, numpy_tree,
                               sharded_serving_rank, sharded_synth)

torch.set_num_threads(1)

S = SHARD_S
T = 21                 # one 16-frame chunk + a 5-frame tail (bucket 8)
T3 = 20                # world 3: one 15-frame chunk + a tail, bucket 9
MAX_CODES = 1
SHARE_BAND = 0.05
STREAM_FRAMES = 18     # 5 blocks of 4 at chunk 4, the last trimmed


def _diff(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def _within(got, want):
    dmax, share = _diff(got, want)
    assert dmax <= MAX_CODES and share < SHARE_BAND, (dmax, share)


@pytest.fixture(scope="module")
def trees():
    """(bfmnet variables, generator params) on the JAX modules' shapes,
    drawn with seeded numpy (no XLA compile)."""
    jcfg = jax_cfg()
    t = 8
    bfm_vars = numpy_tree(JBFMNet(jcfg.bfmnet), jnp.zeros((1, t, 1)),
                          jnp.zeros((1, t * 5, 80)),
                          jnp.full((1,), t, jnp.int32), train=False, seed=1)
    x = jnp.zeros((1, S, S, 6))
    g = numpy_tree(jpx.PixReferNet(jcfg.pixrefer), x, x, x[..., :3],
                   seed=2)["params"]
    return bfm_vars, g


@pytest.fixture(scope="module")
def states(trees):
    bfm_vars, g = trees
    return tuple({k: v.numpy() for k, v in
                  weights.state_dict_from_flax(tree).items()}
                 for tree in (bfm_vars, g))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    model = tbfm.synthetic_bfm(num_theta=SHARD_BFM[0], num_phi=SHARD_BFM[1],
                               seed=SHARD_BFM[2])
    coeff = np.repeat(tbfm.demo_coeff(model, batch=1, seed=3), T, 0)
    coeff[:, 80:144] += rng.randn(T, 64).astype(np.float32) * 0.3
    ref = rng.rand(S, S, 3).astype(np.float32)
    fg = rng.rand(S, S, 3).astype(np.float32)
    bgs = rng.rand(2, S, S, 3).astype(np.float32)
    n = STREAM_FRAMES * 640
    tt = np.arange(n) / 16000
    pcm = (0.3 * np.sin(2 * np.pi * 220 * tt)
           + 0.05 * rng.randn(n)).astype(np.float32)
    units = rng.randn(2, 4, 16, 12).astype(np.float32)
    return dict(coeff=coeff, ref=ref, fg=fg, bgs=bgs, pcm=pcm, units=units)


def _unit_modules():
    g = torch.Generator().manual_seed(5)
    conv = px.GenConv(4, 5)
    deconv = px.GenDeconv(4, 5)
    with torch.no_grad():
        for m in (conv, deconv):
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return conv, deconv


def _np_state(m):
    return {k: v.numpy() for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def world2(states, inputs):
    i = inputs
    conv, deconv = _unit_modules()
    cases = {
        "frames": ("frames", 16, "render",
                   (i["coeff"], i["ref"], i["fg"], i["bgs"])),
        "spatial": ("spatial", 4, "render",
                    (i["coeff"][:4], i["ref"], i["fg"], i["bgs"])),
        "stream": ("spatial", 4, "stream",
                   (i["pcm"], i["ref"], i["fg"], 3200)),
    }
    return run_ranks(sharded_serving_rank, 2, states, cases,
                     (i["units"], _np_state(conv), _np_state(deconv)))


@pytest.fixture(scope="module")
def world3(states, inputs):
    i = inputs
    cases = {"frames": ("frames", 16, "render",
                        (i["coeff"][:T3], i["ref"], i["fg"], i["bgs"]))}
    return run_ranks(sharded_serving_rank, 3, states, cases, None)


@pytest.fixture(scope="module")
def world4(states, inputs):
    i = inputs
    cases = {"spatial": ("spatial", 4, "render",
                         (i["coeff"][:4], i["ref"], i["fg"], i["bgs"]))}
    return run_ranks(sharded_serving_rank, 4, states, cases, None)


@pytest.fixture(scope="module")
def single(states, inputs):
    """The port's single-process frames of each case."""
    i = inputs
    out = {}
    for chunk, n in ((16, T), (4, 4)):
        synth = sharded_synth(None, states, "frames", chunk)
        ident = tsyn.synthetic_identity(synth.face_model, 0, S)
        out[chunk] = synth.render_frames(i["coeff"][:n], ident, i["ref"],
                                         i["fg"], i["bgs"])
    return out


@pytest.fixture(scope="module")
def jax_frames(trees, inputs):
    """The JAX single-device Synthesizer's frames of the same cases."""
    bfm_vars, g = trees
    i = inputs
    jcfg = jax_cfg()
    model = tbfm.synthetic_bfm(num_theta=SHARD_BFM[0], num_phi=SHARD_BFM[1],
                               seed=SHARD_BFM[2])
    ident = jsyn.synthetic_identity(model, 0, S)
    out = {}
    for chunk, n in ((16, T), (4, 4)):
        synth = jsyn.Synthesizer(jcfg, model, bfm_vars, g, chunk=chunk,
                                 raster_bb=24, gan_dtype=jnp.float32,
                                 transfer_format="rgb8")
        out[chunk] = synth.render_frames(i["coeff"][:n], ident, i["ref"],
                                         i["fg"], i["bgs"])
    return out


@pytest.mark.parametrize("against", ["port", "jax"])
def test_frames_partition_matches_single_device(world2, single, jax_frames,
                                                against):
    """World 2, chunk 16 and a 5-frame tail: rank 0's frames against the
    single-process frames; the other rank returns None."""
    want = (single if against == "port" else jax_frames)[16]
    got = world2[0]["frames"]["frames"]
    assert got.shape == (T, S, S, 3)
    _within(got, want)
    assert world2[1]["frames"]["frames"] is None
    assert got.std(axis=0).max() > 0


def test_frames_partition_k1_on_each_ranks_rows(world2):
    """K1 runs on each rank's rows: 8 of the 16-frame chunk, 4 of the
    8-frame tail bucket; the chunk is JAX's rounding of 16 over 2."""
    for r in world2:
        assert r["frames"]["k1"] == [8, 4]
        assert r["frames"]["chunk"] == 16


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("against", ["port", "jax"])
def test_spatial_partition_matches_single_device(world2, world4, single,
                                                 jax_frames, world, against):
    """Height split over 2 ranks (levels down to 4 rows split) and over 4
    (the 4- and 2-row levels whole on every rank): rank 0's frames against
    the single-process frames; the chunk stays 4 and every rank
    rasterizes the whole chunk (K1 on 4 frames)."""
    ranks = world2 if world == 2 else world4
    want = (single if against == "port" else jax_frames)[4]
    got = ranks[0]["spatial"]["frames"]
    _within(got, want)
    for r in ranks:
        assert r["spatial"]["chunk"] == 4
        assert r["spatial"]["k1"] == [4]
    assert all(r["spatial"]["frames"] is None for r in ranks[1:])


def test_frames_tail_bucket_rounded_to_the_world(world3, states, trees,
                                                 inputs):
    """World 3: chunk 16 rounds down to 15 and the 5-frame tail's bucket
    8 rounds up to 9 (one frame more than one process renders), as the
    JAX Synthesizer rounds them (synthesize.py:210-212, 441-449); the
    frames equal one process's frame program on the same padded chunks
    (15 and 9 frames, so the generator's BN moments cover 15 and 9
    frames), the port's and the JAX single-device program's."""
    i = inputs
    assert all(r["frames"]["chunk"] == 15 for r in world3)
    assert all(r["frames"]["k1"] == [5, 3] for r in world3)
    assert tsyn.tail_bucket(5, 15, 3) == 9 and tsyn.tail_bucket(5, 15) == 8
    angles = tsyn.head_sway_angles(T3)
    chunks = []
    for start, cc in ((0, 15), (15, 9)):
        n = min(cc, T3 - start)
        coeff = np.zeros((cc, 257), np.float32)
        coeff[:n] = i["coeff"][start:start + n]
        ang = np.zeros((cc, 3), np.float32)
        ang[:n] = angles[start:start + n]
        idx = np.zeros((cc,), np.int32)
        idx[:n] = np.arange(start, start + n) % 2
        chunks.append((n, coeff, ang, idx))
    synth = sharded_synth(None, states, "frames", 15)
    geo = synth.frame_geometry(tsyn.synthetic_identity(synth.face_model, 0,
                                                       S))
    port = []
    with torch.inference_mode():
        for n, coeff, ang, idx in chunks:
            out = synth.frame_program(
                geo, torch.as_tensor(coeff), torch.as_tensor(ang),
                torch.as_tensor(i["bgs"]), torch.as_tensor(idx).long(),
                torch.as_tensor(i["ref"]), torch.as_tensor(i["fg"]))
            port.append(out.numpy()[:n])
    bfm_vars, g = trees
    model = tbfm.synthetic_bfm(num_theta=SHARD_BFM[0], num_phi=SHARD_BFM[1],
                               seed=SHARD_BFM[2])
    jsynth = jsyn.Synthesizer(jax_cfg(), model, bfm_vars, g, chunk=15,
                              raster_bb=24, gan_dtype=jnp.float32,
                              transfer_format="rgb8")
    prog = jsynth.frame_program_for(jsyn.synthetic_identity(model, 0, S))
    jax_out = []
    for n, coeff, ang, idx in chunks:
        out, _, _ = prog(jsynth.g_params, jnp.asarray(coeff),
                         jnp.asarray(ang), jnp.asarray(i["bgs"]),
                         jnp.asarray(idx), jnp.asarray(i["ref"]),
                         jnp.asarray(i["fg"]))
        jax_out.append(jsynth.fetch_frames(out, n))
    got = world3[0]["frames"]["frames"]
    _within(got, np.concatenate(port))
    _within(got, np.concatenate(jax_out))
    assert world3[1]["frames"]["frames"] is None


@pytest.mark.parametrize("world,chunk", [(2, 16), (3, 16), (4, 6), (8, 3),
                                         (8, 32), (3, 2)])
def test_frames_chunk_rounding_equals_jax(trees, world, chunk):
    """The chunk of a frames partition is the JAX Synthesizer's on a mesh
    of as many devices (rounded down, at least the world)."""
    import jax
    bfm_vars, g = trees
    model = tbfm.synthetic_bfm(num_theta=SHARD_BFM[0], num_phi=SHARD_BFM[1],
                               seed=SHARD_BFM[2])
    want = jsyn.Synthesizer(jax_cfg(), model, bfm_vars, g, chunk=chunk,
                            mesh=jmesh.make_mesh(jax.devices()[:world]))
    assert tsyn.frames_chunk(chunk, world) == want.chunk


def test_streaming_over_a_spatial_synth_matches_single(world2, states,
                                                       inputs):
    """A StreamingSynthesizer over a 2-rank spatial synth: rank 0's blocks
    equal one process's stream within the frame band; rank 1 yields
    none."""
    i = inputs
    synth = sharded_synth(None, states, "frames", 4)
    ident = tsyn.synthetic_identity(synth.face_model, 0, S)
    ss = tstream.StreamingSynthesizer(synth, ident, i["ref"], i["fg"])
    want = []
    for k in range(0, i["pcm"].shape[0], 3200):
        want += ss.feed(i["pcm"][k:k + 3200])
    want += ss.flush()
    got = world2[0]["stream"]["frames"]
    assert len(got) == len(want) > 1
    assert sum(b.shape[0] for b in got) == STREAM_FRAMES
    _within(np.concatenate(got), np.concatenate(want))
    assert world2[1]["stream"]["frames"] == []


@pytest.mark.parametrize("kind", ["conv", "deconv"])
def test_halo_rows_equal_the_unsplit_conv(world2, inputs, kind):
    conv, deconv = _unit_modules()
    m = conv if kind == "conv" else deconv
    with torch.no_grad():
        want = m(torch.as_tensor(inputs["units"])).numpy()
    got = np.concatenate([r[f"{kind}_rows"] for r in world2], 2)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_sharded_bn_moments_equal_the_unsplit(world2, inputs):
    x = inputs["units"].astype(np.float64)
    want = np.stack([x.mean((0, 2, 3)),
                     (inputs["units"] ** 2).astype(np.float64).mean(
                         (0, 2, 3))])
    for r in world2:
        np.testing.assert_allclose(r["moments"], want, rtol=1e-12)


def test_sharded_bn_rows_equal_the_unsplit(world2, inputs):
    bn = px.StatelessBatchNorm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 4))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 4))
        want = bn(torch.as_tensor(inputs["units"])).numpy()
    got = np.concatenate([r["bn_rows"] for r in world2], 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fmt", tsyn.TRANSFER_FORMATS)
def test_packed_bands_join_into_the_packed_chunk(world, fmt):
    """Each rank of a spatial partition packs its band of rows; the bands
    joined on rank 0 are the whole chunk packed, byte for byte."""
    frames = torch.rand(3, 16, 16, 3,
                        generator=torch.Generator().manual_seed(world))
    bands = [tsyn.pack_frames(b, fmt) for b in frames.chunk(world, 1)]
    assert torch.equal(tsyn.join_packed_rows(bands, fmt),
                       tsyn.pack_frames(frames, fmt))


@pytest.mark.parametrize("partition", ["frames", "spatial"])
def test_world_one_mesh_is_byte_identical(monkeypatch, states, inputs,
                                          single, partition):
    """A mesh of one rank (make_mesh outside torchrun) serves the plain
    path: the same chunk, the same bytes."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = pm.make_mesh("cpu")
    assert mesh.world == 1
    i = inputs
    synth = sharded_synth(mesh, states, partition, 16)
    ident = tsyn.synthetic_identity(synth.face_model, 0, S)
    got = synth.render_frames(i["coeff"], ident, i["ref"], i["fg"], i["bgs"])
    assert synth.chunk == 16 and synth.is_main
    np.testing.assert_array_equal(got, single[16])


@pytest.mark.parametrize("partition", ["rows", "height", ""])
def test_bad_mesh_partition_raises(states, partition):
    with pytest.raises(ValueError, match="mesh_partition"):
        sharded_synth(None, states, partition, 16)


def test_mesh_of_ranks_without_a_group_raises(states):
    """A several-rank mesh with no process group never serves alone."""
    mesh = pm.DataGroup(0, 2, torch.device("cpu"), None)
    with pytest.raises(RuntimeError, match="no initialized process group"):
        sharded_synth(mesh, states, "frames", 16)


def test_orthogonal_init_is_independent_of_the_thread_count():
    """One seed gives every process the same weights: the GRU kernels'
    orthogonal init (the blocked LAPACK QR) no longer rounds with the
    CPU thread count.  (With 8 threads the 512x512 kernel of Config()'s
    GRU moved by 1.7e-6, enough to flip a raster pixel of a spawned
    rank's frames against the parent's.)"""
    from voicepuppet_torch.models.layers import orthogonal_
    saved = torch.get_num_threads()
    got = []
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            w = torch.empty(512, 512)
            with torch.no_grad():
                orthogonal_(w, torch.Generator().manual_seed(3))
            got.append(w)
    finally:
        torch.set_num_threads(saved)
    assert torch.equal(got[0], got[1])
