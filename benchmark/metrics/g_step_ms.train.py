"""The trainer step's G half (VGG trunk, D on the fake, G's backward and
update): median CUDA-event ms from after D to after G."""


def read(data):
    return data.get("g_step_ms")
