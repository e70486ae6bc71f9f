"""The no-grad G forward whose output D takes as a constant, inside the
D half: the median device ms of the system's ``vp.train.g_const`` span
over the window's steps."""
import math


def read(data):
    v = data.get("g_const_span_ms")
    return v if v is not None and math.isfinite(v) else None
