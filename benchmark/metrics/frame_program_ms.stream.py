"""The frame program at the stream's chunk (16) with the grouped raster
K4: ms per block by CUDA events, k programs with a carried dependence
timed against one."""
import math


def read(data):
    v = data.get("frame_program_ms")
    return v if v is not None and math.isfinite(v) else None
