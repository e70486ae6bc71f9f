"""The PixFlow frame program inside the window: the median device ms of
the system's ``vp.render.chunk`` span over the window's full 32-frame
chunks (inputs, decode, K1, G's per-frame part, pack, the copy's start),
by ``benchmark/spans.py``'s arithmetic."""
import math


def read(data):
    v = data.get("frame_span_ms")
    return v if v is not None and math.isfinite(v) else None
