"""The drain's native YUV 4:2:0 unpack (``csrc/vp_drain.cpp`` through
``pipeline/drain_native.py``) against the JAX package's
``_unpack_yuv420`` and the port's numpy oracle
``synthesize._unpack_yuv420``, byte for byte: random chunks, the planes'
extremes and every chroma pair; the serving drain's frames against the
oracle of its own packed chunks, with the served-frame counter; the library
built at first use, never at import, and released GIL."""

import ctypes
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from voicepuppet_tpu.pipeline import synthesize as jsyn

from voicepuppet_torch.face3d import bfm as tbfm
from voicepuppet_torch.pipeline import drain_native
from voicepuppet_torch.pipeline import synthesize as tsyn
from voicepuppet_torch.utils import native, tracing

from _torch_port_cases import port_cfg

torch.set_num_threads(1)


def _planes(y, u, v):
    """[N,S,S] luma and [N,S/2,S/2] chroma planes -> packed [N, S*S*3//2]."""
    n = y.shape[0]
    return np.concatenate([y.reshape(n, -1), u.reshape(n, -1),
                           v.reshape(n, -1)], 1).astype(np.uint8)


def _same(packed, s):
    """The served unpack equals the JAX package's and the port's oracle."""
    got = drain_native.unpack_yuv420(packed, s)
    for unpack in (jsyn._unpack_yuv420, tsyn._unpack_yuv420):
        want = unpack(packed, s)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# S 8: the plain loop alone; 64, 512: the 8-block steps; 24: both
@pytest.mark.parametrize("n", [1, 7, 32])
@pytest.mark.parametrize("s", [8, 24, 64, 512])
def test_random_chunks_match_the_oracle(s, n):
    rng = np.random.default_rng(1000 * s + n)
    _same(rng.integers(0, 256, (n, s * s * 3 // 2), dtype=np.uint8), s)


@pytest.mark.parametrize("s", [8, 16])
def test_plane_extremes_match_the_oracle(s):
    """One frame for each of Y, U, V at 0, 128 and 255: the clamps at both
    ends and the negative shifts."""
    h = s // 2
    combos = list(itertools.product((0, 128, 255), repeat=3))
    n = len(combos)
    y, u, v = (np.empty((n, s, s)), np.empty((n, h, h)), np.empty((n, h, h)))
    for i, (a, b, c) in enumerate(combos):
        y[i], u[i], v[i] = a, b, c
    _same(_planes(y, u, v), s)


def test_every_chroma_pair_matches_the_oracle():
    """All 65536 (U, V) pairs at once, one a 2x2 block of a 512² frame,
    under luma at 0, at 255, at 128 and at random."""
    s, h = 512, 256
    u, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rng = np.random.default_rng(7)
    y = np.stack([np.full((s, s), 0), np.full((s, s), 255),
                  np.full((s, s), 128), rng.integers(0, 256, (s, s))])
    n = y.shape[0]
    _same(_planes(y, np.broadcast_to(u, (n, h, h)),
                  np.broadcast_to(v, (n, h, h))), s)


def test_layout_is_checked_and_views_are_read_as_values():
    with pytest.raises(ValueError, match="even"):
        drain_native.unpack_yuv420(np.zeros((1, 96), np.uint8), 7)
    with pytest.raises(ValueError, match="96"):
        drain_native.unpack_yuv420(np.zeros((1, 95), np.uint8), 8)
    rng = np.random.default_rng(3)
    wide = rng.integers(0, 256, (5, 2 * 96), dtype=np.uint8)
    _same(wide[:, ::2], 8)        # a strided view: copied, then unpacked
    _same(wide[:0, :96], 8)       # no frames


def test_library_builds_at_first_use_and_releases_the_gil(tmp_path,
                                                          monkeypatch):
    code = ("import voicepuppet_torch.pipeline.synthesize\n"
            "from voicepuppet_torch.pipeline import drain_native\n"
            "assert drain_native._lib is None, 'built at import'\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
    lib = drain_native._load()
    # a CDLL call drops the GIL; a PyDLL call would hold it
    assert isinstance(lib, ctypes.CDLL) and not isinstance(lib, ctypes.PyDLL)
    path = native.build_library(drain_native._SRC, "vp_drain")
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libvp_drain_")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build_library(drain_native._SRC, "vp_drain", str(tmp_path))


S = 256
CHUNK = 16
T = 21          # one full chunk and a 5-frame tail


@pytest.fixture(scope="module")
def parts():
    cfg = port_cfg()
    model = tbfm.synthetic_bfm(num_theta=16, num_phi=16, seed=1)
    bfm_state, g_state = tsyn.SynthesisAssets.init_trees(cfg, seed=0)
    ident = tsyn.synthetic_identity(model, seed=2, img_size=S)
    return cfg, model, bfm_state, g_state, ident


@pytest.mark.parametrize("fmt", ["yuv420", "rgb8"])
def test_drain_serves_the_oracle_bytes_and_counts_them(parts, fmt,
                                                       monkeypatch):
    """The frames a call returns are the oracle's unpack (yuv420, the
    JAX package's too) or the bytes (rgb8) of the chunks its frame program
    packed; the served-frame counter reads every frame."""
    cfg, model, bfm_state, g_state, ident = parts
    packed = []
    start_fetch = tsyn.Synthesizer.start_fetch

    def keep(self, out):
        packed.append(out.clone())
        return start_fetch(self, out)

    monkeypatch.setattr(tsyn.Synthesizer, "start_fetch", keep)
    rng = np.random.RandomState(0)
    panel = rng.rand(S, 3 * S, 3).astype(np.float32)
    coeff = np.repeat(np.asarray(ident.bfmcoeff, np.float32), T, 0)
    coeff[:, 80:144] = rng.randn(T, 64) * 0.3
    with tsyn.Synthesizer(cfg, model, bfm_state, g_state, chunk=CHUNK,
                          raster_bb=24, gan_dtype=torch.float32,
                          transfer_format=fmt, device="cpu") as synth:
        with tracing.recording() as rec:
            frames = synth.render_frames(
                coeff, ident, panel[:, S:2 * S],
                panel[:, :S] * panel[:, 2 * S:],
                tsyn.constant_background(np.zeros((S, S, 3), np.float32)))
    assert [p.shape[0] for p in packed] == [CHUNK, tsyn.tail_bucket(
        T - CHUNK, CHUNK)]
    want = [p.numpy() for p in packed]
    if fmt == "yuv420":
        for p in want:
            np.testing.assert_array_equal(tsyn._unpack_yuv420(p, S),
                                          jsyn._unpack_yuv420(p, S))
        want = [tsyn._unpack_yuv420(p, S) for p in want]
    want = np.concatenate([want[0], want[1][:T - CHUNK]])
    np.testing.assert_array_equal(frames, want)
    assert rec.summary()["counts"]["vp.frames.served"] == T
