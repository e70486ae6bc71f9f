"""The trainer step's D half (G's forward, D three times, D's backward
and update): median CUDA-event ms from the step's start to after D."""


def read(data):
    return data.get("d_step_ms")
