from voicepuppet_torch.ops.raster import (KERNELS, RASTER, RASTER_GROUPED,
                                          RASTER_INTERP,
                                          RASTER_INTERP_GROUPED,
                                          rasterize_triangles_kernel,
                                          rasterize_winner,
                                          rasterize_winner_grouped,
                                          rasterize_winner_interp,
                                          render_colors_grouped,
                                          render_colors_kernel,
                                          render_colors_xband,
                                          render_texture_kernel)


def render_colors_auto(vertices, colors, triangles, h: int = 224,
                       w: int = 224, bb: int = 6, group: int = 0,
                       xband: bool = True):
    """Device-dispatched flat-shaded raster (``voicepuppet_tpu.ops``
    counterpart): the CUDA kernels for CUDA tensors, the plain versions for
    CPU tensors.  ``group`` > 0 selects the grouped kernel K4, whose output
    equals K1's.  ``bb`` and ``xband`` are TPU window/lane knobs, ignored —
    the kernels never crop a triangle."""
    if group > 0:
        return render_colors_grouped(vertices, colors, triangles, h=h, w=w,
                                     group=group)
    if xband:
        return render_colors_xband(vertices, colors, triangles, h=h, w=w)
    return render_colors_kernel(vertices, colors, triangles, h=h, w=w)


__all__ = ["KERNELS", "RASTER", "RASTER_GROUPED", "RASTER_INTERP",
           "RASTER_INTERP_GROUPED", "rasterize_winner",
           "rasterize_winner_grouped", "rasterize_winner_interp",
           "rasterize_triangles_kernel", "render_colors_kernel",
           "render_colors_xband", "render_colors_grouped",
           "render_texture_kernel", "render_colors_auto"]
