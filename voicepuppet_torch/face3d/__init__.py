"""The BFM asset, the 3DMM decode and the plain z-buffer raster
(``voicepuppet_tpu.face3d`` counterpart).  The CUDA kernels are
``voicepuppet_torch.ops``'; nothing here builds or loads them."""

from voicepuppet_torch.face3d.bfm import BFMModel, load_bfm, synthetic_bfm
from voicepuppet_torch.face3d.morph import (split_coeff, shape_formation,
                                            texture_formation, compute_norm,
                                            rotation_matrix,
                                            projection_layer,
                                            illumination_layer, reconstruct,
                                            reconstruct_rotation)
from voicepuppet_torch.face3d.raster import (render_colors,
                                             rasterize_triangles,
                                             render_texture, vertex_normals)

__all__ = [
    "BFMModel", "load_bfm", "synthetic_bfm",
    "split_coeff", "shape_formation", "texture_formation", "compute_norm",
    "rotation_matrix", "projection_layer", "illumination_layer",
    "reconstruct", "reconstruct_rotation",
    "render_colors", "rasterize_triangles", "render_texture",
    "vertex_normals",
]
