"""G's shared part inside the window (the foreground encoder, ``diffnet``
on the reference render and ``pre_resnet``, once a call): the median
device ms of the system's ``vp.render.ref`` span."""
import math


def read(data):
    v = data.get("ref_span_ms")
    return v if v is not None and math.isfinite(v) else None
