"""Device time: CUDA-event timings, the profiler's trace of a slice of
work (busy and idle time, the device operations that took most time and
the longest idle gaps), and the least time of a flat raster call."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12    # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak
RASTER_OPS_PER_TRIANGLE = 20   # setup: depth, edges, dots, deno, 1/deno
RASTER_OPS_PER_BBOX_PIXEL = 20  # 2 sub, 10 mul, 5 add/sub, 3 compares


def carried_ms(step: Callable[[object], object], first, k: int = 8,
               repeats: int = 3) -> float:
    """ms per call of ``step`` run back to back, each call fed a value
    that depends on the previous call's output: ``k`` calls timed against
    one, ``(t_k - t_1) / (k - 1)``, with the minimum of each over
    ``repeats``, by CUDA events.  ``step(x) -> x'``.  NaN where noise
    swamps it (t_k <= t_1)."""
    def run(n):
        x = first
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            x = step(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    run(1)
    run(k)
    t1 = tk = float("inf")
    for _ in range(repeats):
        t1 = min(t1, run(1))
        tk = min(tk, run(k))
    if tk <= t1:
        return float("nan")
    return (tk - t1) / (k - 1)


def held_ms(fn: Callable[[], object], iters: int, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn`` on the current stream.  A spin
    kernel first holds the stream for ~50 ms while the host queues the
    timed calls, so a call whose host-side enqueue is slower than its
    device work (a short kernel behind its Python wrapper) is not timed at
    the host's pace."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)      # cycles: ~50 ms at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _is_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def traced(fn: Callable[[], None], top: int = 10) -> Optional[dict]:
    """Run ``fn`` under ``torch.profiler`` with CPU and CUDA activity.
    -> {"busy_s", "window_s", "device_ops", "idle_gaps"} or None where the
    trace holds no device event.  Busy time is the union of the device
    spans; an idle gap is named by the host op (or benchmark span) that
    was running at its middle."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if _is_device(e))
    if not dev:
        return None
    busy, end, gaps = 0.0, None, []
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if not _is_device(e)]

    def doing(t):
        best = None
        for a, b, name in host:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return f"host: {best[2]}" if best else "host: outside any op"

    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[doing((a + b) / 2), (b - a) / 1e6] for a, b in gaps[:top]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=min(busy / 1e6, wall_s), window_s=wall_s,
                device_ops=[[n[:120], t / 1e6] for n, t in ops],
                idle_gaps=idle)


def raster_bound_ms(verts, colors, tris, winner, h: int, w: int
                    ) -> Tuple[float, str]:
    """The least time of one flat raster call: the bytes it must move over
    HBM bandwidth, against the float32 operations these triangles need (per
    live triangle, and per pixel of each clipped bbox) over the float32
    peak.  Bytes: the triangles, each vertex some triangle uses, the
    colours of the distinct corners of the triangles that win a pixel,
    read once; image and mask written once.  -> (ms, which bound)."""
    b, v = verts.shape[:2]
    f, c = tris.shape[0], colors.shape[2]
    won = winner != f
    frame = torch.arange(b, device=winner.device).view(b, 1, 1).expand_as(
        winner)[won]
    corners = tris.long()[winner[won].long()]
    n_colored = torch.unique((frame[:, None] * v + corners).reshape(-1)
                             ).numel()
    nbytes = (b * torch.unique(tris).numel() * 3 * 4 + tris.numel() * 4
              + n_colored * c * 4 + b * h * w * (c + 1))
    corners = verts[:, tris.long()]
    xs, ys, zs = corners[..., 0], corners[..., 1], corners[..., 2]
    bw = (torch.clamp(torch.floor(xs.amax(-1)), max=w - 1.0)
          - torch.clamp(torch.ceil(xs.amin(-1)), min=0.0) + 1).clamp(min=0)
    bh = (torch.clamp(torch.floor(ys.amax(-1)), max=h - 1.0)
          - torch.clamp(torch.ceil(ys.amin(-1)), min=0.0) + 1).clamp(min=0)
    live = zs.sum(-1) / 3.0 > -99999.0
    ops = (RASTER_OPS_PER_TRIANGLE * int(live.sum())
           + RASTER_OPS_PER_BBOX_PIXEL * int((bw * bh * live).sum()))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def host_ms(fn: Callable[[], None], reps: int) -> List[float]:
    """Host-clock ms of each of ``reps`` calls of ``fn``."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out
