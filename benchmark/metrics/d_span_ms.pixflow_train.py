"""The PixFlow step's D half (preprocessing, the no-grad G forward, D
twice, D's backward and update): the median device ms of the system's
``vp.train.d_half`` span over the window's steps."""
import math


def read(data):
    v = data.get("d_span_ms")
    return v if v is not None and math.isfinite(v) else None
