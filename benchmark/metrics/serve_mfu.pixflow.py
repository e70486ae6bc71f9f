"""The served PixFlow step's share of the card's peak: per frame, G's
per-frame FLOPs plus its shared part's FLOPs spread over a call's frames
(the cycle's mean) over the bf16 peak, and BFMNet's over the float32
peak, times the frames a second of the window."""
from benchmark.devicetime import H100_BF16_FLOPS, H100_FP32_OPS_PER_S


def read(data):
    g, c = data.get("gen_flops_per_frame"), data.get("call_flops_per_frame")
    b, fps = data.get("bfm_flops_per_frame"), data.get("fps_window")
    if not g or not c or not b or not fps:
        return None
    return 100.0 * ((g + c) / H100_BF16_FLOPS
                    + b / H100_FP32_OPS_PER_S) * fps
