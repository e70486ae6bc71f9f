"""The device's idle share over a traced slice of two calls after the
window: 1 - (union of device spans) / wall time, in %."""


def read(data):
    busy, window = data.get("busy_s"), data.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
