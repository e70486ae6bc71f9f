"""G's per-frame part inside the window: the median device ms of the
system's ``vp.render.gen`` span over the window's chunks of 32 rows."""
import math


def read(data):
    v = data.get("gen_span_ms")
    return v if v is not None and math.isfinite(v) else None
