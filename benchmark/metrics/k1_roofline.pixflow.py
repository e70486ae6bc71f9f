"""The flat raster kernel K1's share of its roofline at 512², the cell's
chunk of 32: the least time of its bytes and operations over its
CUDA-event time behind a spin that holds the stream."""


def read(data):
    ms, bound = data.get("raster_ms"), data.get("raster_bound_ms")
    if not ms or not bound or ms != ms:
        return None
    return 100.0 * bound / ms
