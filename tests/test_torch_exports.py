"""The port's subpackage exports against the JAX package's ``__all__``,
and the torch ``face3d.raster.vertex_normals`` against the JAX one, on the
CPU.

Every name of a JAX subpackage's ``__all__`` is importable from the same
port subpackage, under the port's own name where the two differ.
Importing the port builds or loads no library (no CUDA build, no g++
build) and imports no JAX.  ``vertex_normals`` is a scatter-add: on
integer-valued normals every partial sum is exact, so it equals JAX's
bit for bit; on float normals the order of the sums may differ, within
1e-6 relative of the largest magnitude.
"""

import importlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicepuppet_tpu.face3d import bfm as jbfm
from voicepuppet_tpu.face3d import raster as jraster

from voicepuppet_torch.face3d import raster as traster

torch.set_num_threads(1)

SUBPACKAGES = ("audio", "data", "face3d", "models", "ops", "parallel",
               "pipeline", "train", "utils")
# JAX name -> the port's: the JAX ``masked_gru`` function is a module,
# ``data_parallel_step`` is the trainers' ``mesh=`` with the gradient
# all-reduce, and the Pallas entry points are the CUDA kernels' wrappers
PORT_NAMES = {"masked_gru": "MaskedGRU",
              "data_parallel_step": "all_reduce_grads_",
              "render_colors_pallas": "render_colors_kernel",
              "render_colors_grouped_pallas": "render_colors_grouped",
              "render_colors_xband_pallas": "render_colors_xband",
              "rasterize_winner_pallas": "rasterize_winner",
              "rasterize_triangles_pallas": "rasterize_triangles_kernel",
              "render_texture_pallas": "render_texture_kernel"}
FLOAT_REL = 1e-6


def _jax_all(sub):
    return importlib.import_module(f"voicepuppet_tpu.{sub}").__all__


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    port = importlib.import_module(f"voicepuppet_torch.{sub}")
    want = [PORT_NAMES.get(n, n) for n in _jax_all(sub)]
    missing = [n for n in want if not hasattr(port, n)]
    assert not missing, missing
    assert set(want) <= set(port.__all__)


def test_from_import_of_every_name():
    """``from voicepuppet_torch.<sub> import <name>`` as a user writes
    it."""
    for sub in SUBPACKAGES:
        for name in _jax_all(sub):
            ns = {}
            exec(f"from voicepuppet_torch.{sub} import "
                 f"{PORT_NAMES.get(name, name)}", ns)


def test_imports_build_no_library_and_no_jax():
    """In a fresh process: every subpackage imported, then no raster
    library is loaded, no native raster built, nothing of JAX imported."""
    code = (
        "import sys\n"
        f"for sub in {SUBPACKAGES!r}:\n"
        "    __import__('voicepuppet_torch.' + sub)\n"
        "import voicepuppet_torch.bench, voicepuppet_torch.graft_entry\n"
        "from voicepuppet_torch.ops.raster import LIBRARY\n"
        "assert LIBRARY._lib is None, 'raster library loaded'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'voicepuppet_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "native = sys.modules.get('voicepuppet_torch.face3d.raster_native')\n"
        "assert native is None or native._lib is None, 'native built'\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _mesh_normals(integer):
    model = jbfm.synthetic_bfm(num_theta=12, num_phi=12, seed=2)
    tri = np.asarray(model.tri, np.int32) - 1       # 1-based in the asset
    rng = np.random.RandomState(5)
    shape = (2, tri.shape[0], 3)
    n = (rng.randint(-50, 50, shape) if integer
         else rng.randn(*shape)).astype(np.float32)
    return n, tri, model.num_vertices


@pytest.mark.parametrize("integer", [True, False])
def test_vertex_normals_matches_jax(integer):
    n, tri, nv = _mesh_normals(integer)
    want = np.asarray(jraster.vertex_normals(jnp.asarray(n),
                                             jnp.asarray(tri), nv))
    got = traster.vertex_normals(torch.from_numpy(n), torch.from_numpy(tri),
                                 nv)
    assert got.dtype == torch.float32 and got.shape == (2, nv, 3)
    if integer:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= FLOAT_REL * scale


def test_vertex_normals_leading_shape_and_dtype():
    """Any leading batch shape, dtype kept; float64 equals the per-frame
    sequential spec (``raster_ref.vertex_normals_ref``) within rounding."""
    from voicepuppet_torch.face3d.raster_ref import vertex_normals_ref
    n, tri, nv = _mesh_normals(False)
    n64 = torch.from_numpy(n.astype(np.float64)).reshape(2, 1, -1, 3)
    got = traster.vertex_normals(n64, torch.from_numpy(tri), nv)
    assert got.dtype == torch.float64 and got.shape == (2, 1, nv, 3)
    for b in range(2):
        np.testing.assert_allclose(
            got[b, 0].numpy(), vertex_normals_ref(n64[b, 0].numpy(), tri,
                                                  nv), rtol=0, atol=1e-12)
