"""The PixFlow step's G half (G's loss forward, D on its output, G's
backward and update): the median device ms of the system's
``vp.train.g_half`` span over the window's steps."""
import math


def read(data):
    v = data.get("g_span_ms")
    return v if v is not None and math.isfinite(v) else None
