"""G's per-frame part's share of the bf16 peak at the cell's chunk: its
FLOPs, counted on the reference (``flops_pixflow.per_frame_flops``), over
989 TFLOP/s, against its carried CUDA-event time."""
from benchmark.devicetime import H100_BF16_FLOPS


def read(data):
    ms, f = data.get("gen_ms"), data.get("gen_flops")
    if not ms or not f or ms != ms:
        return None
    return 100.0 * (f / H100_BF16_FLOPS * 1e3) / ms
