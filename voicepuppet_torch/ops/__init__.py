from voicepuppet_torch.ops.raster import (RASTER, rasterize_winner,
                                          render_colors_kernel,
                                          render_colors_xband)


def render_colors_auto(vertices, colors, triangles, h: int = 224,
                       w: int = 224, bb: int = 6, group: int = 0,
                       xband: bool = True):
    """Device-dispatched flat-shaded raster (``voicepuppet_tpu.ops``
    counterpart): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``bb`` and ``xband`` are TPU window/lane knobs, ignored —
    the kernel never crops a triangle.  ``group > 0`` (the grouped-RMW
    kernel K4) is not ported yet."""
    if group > 0:
        raise NotImplementedError(
            "raster_group > 0 selects the grouped kernel K4, which is not "
            "ported yet (ROADMAP.md Queue 2, K4)")
    if xband:
        return render_colors_xband(vertices, colors, triangles, h=h, w=w)
    return render_colors_kernel(vertices, colors, triangles, h=h, w=w)


__all__ = ["RASTER", "rasterize_winner", "render_colors_kernel",
           "render_colors_xband", "render_colors_auto"]
