"""The drain's host unpack of one packed chunk of the cell (YUV 4:2:0 to
RGB, ``Synthesizer.fetch_frames``): median host-clock ms of ten."""
import statistics


def read(data):
    ms = data.get("unpack_ms")
    return statistics.median(ms) if ms else None
