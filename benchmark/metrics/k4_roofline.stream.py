"""The grouped raster kernel K4's share of its roofline at the stream's
chunk: the least time of its bytes and operations over its CUDA-event
time."""


def read(data):
    ms, bound = data.get("raster_ms"), data.get("raster_bound_ms")
    if not ms or not bound or ms != ms:
        return None
    return 100.0 * bound / ms
