"""The served step's share of the card's peak: per frame, G's FLOPs over
the bf16 peak and BFMNet's over the float32 peak, times the frames a
second of the untraced window."""
from benchmark.devicetime import H100_BF16_FLOPS, H100_FP32_OPS_PER_S


def read(data):
    g, b = data.get("gen_flops_per_frame"), data.get("bfm_flops_per_frame")
    fps = data.get("fps_window")
    if not g or not b or not fps:
        return None
    return 100.0 * (g / H100_BF16_FLOPS + b / H100_FP32_OPS_PER_S) * fps
