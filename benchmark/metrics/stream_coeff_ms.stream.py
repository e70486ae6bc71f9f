"""The streaming coefficient program (``StreamingCoeffPredictor``: a
52-frame window encode and 16 GRU steps a block) alone on one session's
audio: median host-clock ms a block, each feed ended by a synchronise."""
import statistics


def read(data):
    ms = data.get("stream_coeff_ms")
    return statistics.median(ms) if ms else None
