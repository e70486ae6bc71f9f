"""The training step's share of the float32 peak: one step's FLOPs (G,
D three times and VGG, forward and backward), counted on the reference at
the cell's batch, over 67 TFLOP/s, times the window's steps a second."""
from benchmark.devicetime import H100_FP32_OPS_PER_S


def read(data):
    f, rate = data.get("step_flops"), data.get("steps_per_s")
    if not f or not rate:
        return None
    return 100.0 * f * rate / H100_FP32_OPS_PER_S
