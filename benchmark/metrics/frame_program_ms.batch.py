"""The frame program (decode, raster, G, pack) on one chunk of the cell:
ms per chunk by CUDA events, k programs with a carried dependence timed
against one."""
import math


def read(data):
    v = data.get("frame_program_ms")
    return v if v is not None and math.isfinite(v) else None
