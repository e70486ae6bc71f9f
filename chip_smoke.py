#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (voicepuppet_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (found on PATH, under $CUDA_HOME or
/usr/local/cuda).  Phases, each of which fails the script on any fault:

  1. device and build   print the card's name and power limit; build the
                        raster kernels (csrc/raster.cu: flat K1, grouped K4,
                        interpolated K3 and K5, the probes X1-X3) into
                        build/ and print ptxas's registers and spills.
  2. raster parity      every CUDA kernel against its plain PyTorch version,
                        bit for bit, through every entry point: the quirk,
                        grouped and interp meshes of ops/raster_selftest.py,
                        then the full 189² synthetic mesh at 224² for one
                        32-frame chunk of the main path (K4 at groups 1, 4
                        and 33, K3, K5), K4 against K1 and K5 against K3.
  3. main path          Config() (ngf 64, 512², BFMNet width 1.0),
                        synthetic_bfm(189, 189), chunk 32, random weights
                        from seed 0: Synthesizer.synthesize on 2.2 s of
                        audio (55 frames: one chunk of 32 and a tail bucket
                        of 32), the generator in bfloat16.  The flat raster
                        K1 must launch once per chunk.  Then frames/s over
                        timed repeats, a per-stage time breakdown of one
                        chunk.
  4. streaming path     the same weights in Synthesizer(raster_group=4):
                        StreamingSynthesizer fed the 55-frame clip in 0.2 s
                        pcm pieces, then flush.  The grouped raster K4 must
                        launch once per block emitted; frames uint8, 55,
                        not constant; the streamed coefficients within 2e-2
                        of the batch predict_expressions on interior frames
                        (tests/test_torch_streaming.py); time from first
                        feed to first block, frames/s over the stream.
  5. texture path       render_texture_kernel at 224², B = 32, on the full
                        mesh with texture coordinates from the sphere's
                        (theta, phi) grid and a 256² texture, group 0 (K3)
                        and group 4 (K5): winner and depth bit for bit
                        against the plain version, image within 1e-5, and
                        K5 equal to K3.
  6. kernel times       each kernel beside its plain version and its bound,
                        at the shapes its path gives it.
  7. probe path         the raster A/B probes (ops/raster_probes.py): the
                        probe selftest on every quirk, grouped and interp
                        case and a band-fitting one; at the JAX profile
                        scripts' shapes (B = 16 at 224², the 189² and 192²
                        meshes) each probe bit for bit against its plain
                        version, X2 against K1 at four settings, X1 against
                        K1 off degenerate winners; then every profile entry
                        point (voicepuppet_torch/experiments/) once at
                        K = 2 and one round, where every probe must launch;
                        probe times beside K1's, plain and bound.
  8. reference checks   the card against the port on the CPU (float32
                        everywhere): the full-width expression coefficients,
                        and whole frames at a small size (ngf 8, 256²); the
                        served bf16 generator against its float32 weights on
                        the card at full width, with a bf16-BN-moments
                        control that the band must reject.

Each path runs with every launch count set to 0 just before it and read
just after; a kernel of that path that did not launch fails the script.
Output: progress lines, one JSON line of kernels, the nvidia-smi line, and
as the last line {"ok": true, "device": {...}}.  Exits nonzero, printing
no result, when there is no CUDA device or no voicepuppet_torch beside it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

FRAMES = 55                 # 2.2 s at 25 fps: one chunk of 32 + a tail
CHUNK = 32
SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
RASTER_OPS_PER_TRIANGLE = 20   # setup: depth, edges, dots, deno, 1/deno
RASTER_OPS_PER_BBOX_PIXEL = 20  # 2 sub, 10 mul, 5 add/sub, 3 compares
# interpolated depth: + 4 border compares, 2 sub, 3 mul, 2 add, 1 compare
INTERP_OPS_PER_BBOX_PIXEL = 32
STREAM_PIECE = 3200         # 0.2 s of 16 kHz pcm per feed
STREAM_COEFF_BAND = 2e-2    # interior frames, tests/test_torch_streaming.py
STREAM_INTERIOR = slice(16, 48)
TEX_SIZE = 256
PROBE_BATCH = 16            # the JAX profile scripts' B
# bf16 generator vs float32, mean |diff| in 8-bit codes at full width: the
# served path read 0.145 on an H100, with the BN moments in bf16 0.227
GEN_BF16_MEAN_CODES = 0.185


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters, warmup=2):
    """Mean device milliseconds per call of ``fn`` on the current stream.
    A spin kernel first holds the stream for ~50 ms while the host queues
    the timed calls, so a call whose host-side enqueue is slower than its
    device work is not timed at the host's pace (a call that synchronises
    inside, like the plain raster, still is)."""
    import torch
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


def raster_bound_ms(verts, colors, tris, winner, h, w):
    """Least time for one flat raster call: the bytes it must move over HBM
    bandwidth, against the float32 operations this data needs (per live
    triangle, and per pixel of each clipped bbox) over the float32 peak.
    Bytes: the triangles, each vertex some triangle uses, the colours of the
    distinct corners of the triangles that win a pixel in ``winner`` (the
    only colours the resolve pass reads), read once; image + mask written
    once."""
    import torch
    b, v = verts.shape[:2]
    f, c = tris.shape[0], colors.shape[2]
    won = winner != f
    frame = torch.arange(b, device=winner.device).view(b, 1, 1).expand_as(
        winner)[won]
    corners = tris.long()[winner[won].long()]             # [n, 3]
    n_colored = torch.unique((frame[:, None] * v + corners).reshape(-1)
                             ).numel()
    nbytes = (b * torch.unique(tris).numel() * 3 * 4 + tris.numel() * 4
              + n_colored * c * 4 + b * h * w * (c + 1))
    corners = verts[:, tris.long()]                     # [B,F,3,3]
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
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops, n_colored)


def interp_bound_ms(verts, tris, h, w):
    """Least time for one interpolated-depth raster call (K3/K5): the
    triangles and each vertex some triangle uses, read once, and winner +
    depth written once, over HBM bandwidth; against the float32 operations
    (per finite triangle, and per pixel of each clipped bbox) over the
    float32 peak."""
    import torch
    b = verts.shape[0]
    nbytes = (b * torch.unique(tris).numel() * 3 * 4 + tris.numel() * 4
              + b * h * w * 8)
    corners = verts[:, tris.long()]                     # [B,F,3,3]
    xs, ys = corners[..., 0], corners[..., 1]
    bw = (torch.clamp(torch.floor(xs.amax(-1)), max=w - 1.0)
          - torch.clamp(torch.ceil(xs.amin(-1)), min=0.0) + 1).clamp(min=0)
    bh = (torch.clamp(torch.floor(ys.amax(-1)), max=h - 1.0)
          - torch.clamp(torch.ceil(ys.amin(-1)), min=0.0) + 1).clamp(min=0)
    live = torch.isfinite(corners[..., :2]).all(-1).all(-1)
    ops = (RASTER_OPS_PER_TRIANGLE * int(live.sum())
           + INTERP_OPS_PER_BBOX_PIXEL * int((bw * bh * live).sum()))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def probe_bound_ms(verts, tris, h, w, out_bytes, live, band=None):
    """Least time for one raster probe call: the triangles and each vertex
    some triangle uses, read once, and the probe's own outputs
    (``out_bytes`` per pixel) written once, over HBM bandwidth; against the
    float32 operations per ``live`` [B,F] triangle and per pixel of its
    clipped bbox (``band`` = (first row [B,F], rows): only the rows inside
    X3's band) over the float32 peak."""
    import torch
    b = verts.shape[0]
    nbytes = (b * torch.unique(tris).numel() * 3 * 4 + tris.numel() * 4
              + b * h * w * out_bytes)
    corners = verts[:, tris.long()]                     # [B,F,3,3]
    xs, ys = corners[..., 0], corners[..., 1]
    x0 = torch.clamp(torch.ceil(xs.amin(-1)), min=0.0)
    x1 = torch.clamp(torch.floor(xs.amax(-1)), max=w - 1.0)
    y0 = torch.clamp(torch.ceil(ys.amin(-1)), min=0.0)
    y1 = torch.clamp(torch.floor(ys.amax(-1)), max=h - 1.0)
    if band is not None:
        start, rows = band
        y0 = torch.maximum(y0, start.float())
        y1 = torch.minimum(y1, start.float() + (rows - 1))
    area = (x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)
    ops = (RASTER_OPS_PER_TRIANGLE * int(live.sum())
           + RASTER_OPS_PER_BBOX_PIXEL * int((area * live).sum()))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def bn_forward_bf16_moments(self, x):
    """Negative control for the generator's precision gate: StatelessBatchNorm
    with its moments and normalisation taken in bfloat16, which the served
    path must not do."""
    import torch
    xb = x.to(torch.bfloat16)
    mean = xb.mean(dim=(0, 2, 3), keepdim=True)
    var = torch.square(xb).mean(dim=(0, 2, 3), keepdim=True) - torch.square(
        mean)
    y = ((xb - mean) * torch.rsqrt(var + self.epsilon)
         * self.weight.to(xb.dtype).view(1, -1, 1, 1)
         + self.bias.to(xb.dtype).view(1, -1, 1, 1))
    return y.to(x.dtype)


def code_diff(got, want):
    """Generator outputs in [-1, 1] -> (mean, max) |diff| in 8-bit codes."""
    d = (got - want).abs() * 127.5
    return float(d.mean()), float(d.max())


def frame_diff(a, b):
    import numpy as np
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return float(d.mean()), float((d > 1).mean()), int(d.max())


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "voicepuppet_torch")):
        print(f"chip_smoke: no voicepuppet_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.face3d import bfm, morph
    from voicepuppet_torch.face3d import raster as plain
    from voicepuppet_torch.models import pixrefer as px
    from voicepuppet_torch import ops as tops
    from voicepuppet_torch.ops import KERNELS, render_colors_auto
    from voicepuppet_torch.ops import raster_probes as probes
    from voicepuppet_torch.ops import raster_selftest
    from voicepuppet_torch.ops.raster import LIBRARY
    from voicepuppet_torch.experiments import _common as probe_common
    from voicepuppet_torch.experiments import (profile_raster,
                                               profile_raster2,
                                               profile_raster3,
                                               profile_raster_grouped,
                                               profile_raster_regacc)
    from voicepuppet_torch.pipeline import streaming
    from voicepuppet_torch.pipeline import synthesize as syn
    from voicepuppet_torch.pipeline.align import head_sway_angles

    every_kernel = KERNELS + probes.PROBE_KERNELS

    def reset_counts():
        for k in every_kernel:
            k.launches = 0

    def counts():
        return {k.name: k.launches for k in every_kernel}

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    LIBRARY.function()
    log(f"build: raster kernels (K1, K4, K3, K5 and the probes X1-X3: "
        f"csrc/raster.cu) in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in LIBRARY.build_log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"  ptxas: {line.strip()}")

    # ---- 2. raster parity on the quirk meshes ---------------------------
    t0 = time.perf_counter()
    report = raster_selftest.run_selftest(dev)
    torch.cuda.synchronize()
    log(f"parity: {len(report)} quirk cases bit-exact kernel == plain "
        f"(K1; K4 at groups {raster_selftest.GROUP_SIZES}; K3; K5), "
        f"({time.perf_counter() - t0:.2f} s): {json.dumps(report)}")

    # ---- 3. the main path at full width ---------------------------------
    cfg = tcfg.Config()
    face_model = bfm.synthetic_bfm(num_theta=189, num_phi=189)
    trees = syn.SynthesisAssets.init_trees(cfg, SEED)
    synth = syn.Synthesizer(cfg, face_model, *trees, chunk=CHUNK)
    identity = syn.synthetic_identity(face_model, SEED,
                                      cfg.pixrefer.img_size)
    s = cfg.pixrefer.img_size
    rng = np.random.RandomState(SEED)
    n_pcm = (FRAMES - 1) * cfg.frame_wav_scale
    tt = np.arange(n_pcm) / cfg.mel.sample_rate
    pcm = (0.3 * np.sin(2 * np.pi * 180 * tt) * np.sin(2 * np.pi * 3 * tt)
           + 0.05 * rng.randn(n_pcm)).astype(np.float32)
    panel = rng.rand(s, 3 * s, 3).astype(np.float32)
    nf = synth.fm.tri.shape[0]
    log(f"main path: ngf {cfg.pixrefer.ngf}, {s}², mesh "
        f"{face_model.num_vertices} vertices / {nf} triangles, chunk "
        f"{CHUNK}, {FRAMES} frames, G {next(synth.gen.parameters()).dtype}")

    # the full mesh at 224² on the main path's first chunk
    with torch.inference_mode():
        exp = synth.predict_expressions(pcm)
        coeff = syn.splice_coeff_sequence(identity.bfmcoeff, exp)[:CHUNK]
        angles = torch.as_tensor(head_sway_angles(FRAMES)[:CHUNK],
                                 device=dev)
        rec = morph.reconstruct_rotation(coeff, synth.fm, angles,
                                         image_size=224.0)
        verts = torch.cat([rec.face_projection, rec.z_buffer],
                          -1).contiguous()
        colors = torch.floor(torch.clamp(rec.face_color, 0.0,
                                         255.0)).contiguous()
        tri = synth.fm.tri
        covered = raster_selftest.check_against_plain(
            verts, colors, tri, 224, 224, "full mesh")
        want_img, want_mask = plain.render_colors(verts, colors, tri)
        got_img, got_mask = render_colors_auto(verts, colors, tri, h=224,
                                               w=224, bb=synth.raster_bb)
        torch.cuda.synchronize()
        raster_selftest.expect_equal(got_mask, want_mask, "auto mask")
        raster_selftest.expect_equal(got_img, want_img, "auto image")
        max_abs_err = int((got_img.int() - want_img.int()).abs().max())
        g_img, g_mask = render_colors_auto(verts, colors, tri, h=224, w=224,
                                           group=4)
        want_g = plain.render_colors(verts, colors, tri, 224, 224, group=4)
        raster_selftest.expect_equal(g_mask, want_g[1], "auto group 4 mask")
        raster_selftest.expect_equal(g_img, want_g[0], "auto group 4 image")
        k4_err = int((g_img.int() - want_g[0].int()).abs().max())
        k1_w = tops.rasterize_winner(verts, tri, 224, 224)
        k4_w = tops.rasterize_winner_grouped(verts, tri, 224, 224, group=4)
        k3_w = tops.rasterize_winner_interp(verts, tri, 224, 224)
        k5_w = tops.rasterize_winner_interp(verts, tri, 224, 224, group=4)
        p3_w = plain.rasterize_winner_interp(verts, tri, 224, 224)
        torch.cuda.synchronize()
        for a, b, label in ((k4_w, k1_w, "K4 == K1"), (k5_w, k3_w,
                                                        "K5 == K3")):
            raster_selftest.expect_equal(a[0], b[0], f"{label} winner")
            raster_selftest.expect_equal(a[1], b[1], f"{label} depth")
        k3_err = float((k3_w[1] - p3_w[1]).abs().max())
        k5_err = float((k5_w[1] - p3_w[1]).abs().max())
        interp_covered = int((k3_w[0] < nf).sum())
    log(f"parity: full mesh B={CHUNK} 224² bit-exact kernel == plain "
        f"through render_colors_auto (K1, K4 group 4) and for K4 at groups "
        f"{raster_selftest.GROUP_SIZES}, K3, K5; K4 == K1 and K5 == K3 bit "
        f"for bit; {covered / CHUNK:.0f} covered px/frame flat, "
        f"{interp_covered / CHUNK:.0f} interp")

    n_chunks = -(-FRAMES // CHUNK)
    reset_counts()
    t0 = time.perf_counter()
    frames = synth.synthesize(panel, pcm, identity)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = counts()
    launches = launched["raster_flat"]
    if launches != n_chunks or sum(launched.values()) != launches:
        raise AssertionError(f"main path launches {launched} for "
                             f"{n_chunks} chunks: K1 once per chunk and "
                             "nothing else")
    if frames.shape != (FRAMES, s, s, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.dtype} {frames.shape}")
    if not frames.std(axis=0).max() > 0 or frames.max() == 0:
        raise AssertionError("frames are constant")
    log(f"main path: synthesize -> {frames.shape} {frames.dtype}, raster "
        f"launches {launches} for {n_chunks} chunks, first call "
        f"{first_s:.3f} s")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        synth.synthesize(panel, pcm, identity)
        times.append(time.perf_counter() - t0)
    fps = [FRAMES / t for t in times]
    log(f"main path: frames/s {json.dumps([round(f, 2) for f in fps])} "
        f"(median {sorted(fps)[len(fps) // 2]:.2f}) over {FRAMES} frames, "
        f"{card}")

    # per-stage device time of one full chunk
    with torch.inference_mode():
        geo = synth.frame_geometry(identity)
        bg = torch.zeros((1, s, s, 3), device=dev)
        idx = torch.zeros((CHUNK,), dtype=torch.int64, device=dev)
        ref = torch.as_tensor(panel[:, s:2 * s], device=dev)
        fg = torch.as_tensor(panel[:, :s], device=dev)
        inputs = px.preprocess(torch.rand((CHUNK, s, s, 6), device=dev))
        fg_in = px.preprocess(torch.rand((CHUNK, s, s, 6), device=dev))
        out = torch.rand((CHUNK, s, s, 3), device=dev)
        stages = {
            "coeff_program_whole_clip": lambda: synth.predict_expressions(
                pcm),
            "decode_reconstruct_rotation": lambda: morph.reconstruct_rotation(
                coeff, synth.fm, angles, image_size=224.0),
            "raster_render_colors_auto": lambda: render_colors_auto(
                verts, colors, tri, h=224, w=224),
            "generator_pixrefernet": lambda: synth.gen(inputs, fg_in,
                                                       inputs[..., :3]),
            "yuv420_pack": lambda: syn._pack_yuv420(out),
            "frame_program_total": lambda: synth.frame_program(
                geo, coeff, angles, bg, idx, ref, fg),
        }
        breakdown = {k: round(cuda_ms(f, 5), 4) for k, f in stages.items()}
    log(f"breakdown ms per chunk of {CHUNK}: {json.dumps(breakdown)}")
    packed = syn._pack_yuv420(out).cpu().numpy()
    unpack_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        syn._unpack_yuv420(packed, s)
        unpack_s.append(time.perf_counter() - t0)
    log(f"host: numpy YUV 4:2:0 unpack {min(unpack_s) * 1e3:.1f} ms per "
        f"chunk of {CHUNK} (best of 3)")
    wall_ms = sorted(times)[len(times) // 2] * 1e3
    device_ms = (breakdown["coeff_program_whole_clip"]
                 + n_chunks * breakdown["frame_program_total"])
    log(f"main path: device ~{device_ms:.1f} ms of {wall_ms:.1f} ms per "
        f"synthesize call, idle share ~{1 - device_ms / wall_ms:.2f} "
        f"(from the stage times above)")

    # the kernel against the plain version and the bound, same inputs
    with torch.inference_mode():
        k_ms = cuda_ms(lambda: render_colors_auto(verts, colors, tri,
                                                  h=224, w=224), 50, 5)
        p_ms = cuda_ms(lambda: plain.render_colors(verts, colors, tri),
                       5, 1)
        v4, c4 = verts[:4].contiguous(), colors[:4].contiguous()
        k4_ms = cuda_ms(lambda: render_colors_auto(v4, c4, tri, h=224,
                                                   w=224), 50, 5)
        p4_ms = cuda_ms(lambda: plain.render_colors(v4, c4, tri), 5, 1)
        winner, _ = plain.rasterize_winner(verts, tri, 224, 224)
        bound, bound_by, nbytes, ops, n_colored = raster_bound_ms(
            verts, colors, tri, winner, 224, 224)
    log(f"raster B={CHUNK}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({bound_by}: {nbytes} B, {ops} ops; "
        f"{n_colored} winning corner colours of {CHUNK * colors.shape[1]}), "
        f"kernel/bound {k_ms / bound:.2f}; "
        f"B=4: kernel {k4_ms:.4f} ms, plain {p4_ms:.4f} ms; {card}")

    # ---- 4. the streaming path at full width: the grouped raster K4 -----
    stream_synth = syn.Synthesizer(cfg, face_model, *trees, chunk=CHUNK,
                                   raster_group=4)
    # 55 frames of pcm: the main path's 54 x 640 samples and one frame more
    pcm_stream = np.concatenate([pcm, (0.05 * np.random.RandomState(
        SEED + 2).randn(cfg.frame_wav_scale)).astype(np.float32)])
    ref_np, fg_np = panel[:, s:2 * s], panel[:, :s]

    def run_stream():
        ss = streaming.StreamingSynthesizer(stream_synth, identity, ref_np,
                                            fg_np)
        blocks, first = [], None
        t0 = time.perf_counter()
        for i in range(0, pcm_stream.shape[0], STREAM_PIECE):
            blocks += ss.feed(pcm_stream[i:i + STREAM_PIECE])
            if blocks and first is None:
                first = time.perf_counter() - t0
        blocks += ss.flush()
        total = time.perf_counter() - t0
        return blocks, (total if first is None else first), total

    run_stream()                                        # warm-up
    stream_runs = []
    for i in range(3):
        if i == 0:
            reset_counts()
        blocks, first_block_s, total_s = run_stream()
        if i == 0:
            stream_launched = counts()
            stream_blocks = blocks
        stream_runs.append((first_block_s, total_s))
    k4_launches = stream_launched["raster_grouped"]
    if (k4_launches != len(stream_blocks)
            or sum(stream_launched.values()) != k4_launches):
        raise AssertionError(f"streaming launches {stream_launched} for "
                             f"{len(stream_blocks)} blocks: K4 once per "
                             "block and nothing else")
    streamed = np.concatenate(stream_blocks)
    if streamed.shape != (FRAMES, s, s, 3) or streamed.dtype != np.uint8:
        raise AssertionError(f"streamed frames {streamed.dtype} "
                             f"{streamed.shape}")
    if not streamed.std(axis=0).max() > 0 or streamed.max() == 0:
        raise AssertionError("streamed frames are constant")
    sp = streaming.StreamingCoeffPredictor(stream_synth, chunk=CHUNK)
    coeff_blocks = []
    for i in range(0, pcm_stream.shape[0], STREAM_PIECE):
        coeff_blocks += sp.feed(pcm_stream[i:i + STREAM_PIECE])
    streamed_exp = torch.cat(coeff_blocks + sp.flush())
    batch_exp = stream_synth.predict_expressions(pcm)[0]
    stream_err = float((streamed_exp[STREAM_INTERIOR]
                        - batch_exp[STREAM_INTERIOR]).abs().max())
    if not stream_err < STREAM_COEFF_BAND:
        raise AssertionError(f"streamed coefficients off the batch path by "
                             f"{stream_err} on frames {STREAM_INTERIOR}")
    log(f"streaming path: {len(stream_blocks)} blocks "
        f"{[b.shape[0] for b in stream_blocks]} -> {streamed.shape} "
        f"{streamed.dtype}, K4 launches {k4_launches}; coefficients vs batch "
        f"max |diff| {stream_err:.3g} on frames {STREAM_INTERIOR.start}-"
        f"{STREAM_INTERIOR.stop - 1} (band {STREAM_COEFF_BAND})")
    log(f"streaming path: first feed to first block "
        f"{json.dumps([round(r[0] * 1e3, 1) for r in stream_runs])} ms, "
        f"frames/s over the stream "
        f"{json.dumps([round(FRAMES / r[1], 2) for r in stream_runs])} "
        f"(3 warm runs, {STREAM_PIECE}-sample feeds fed as fast as they "
        f"return; lookahead {CHUNK} + 12 frames of audio), {card}")
    del stream_synth

    # ---- 5. the texture path: K3 (group 0) and K5 (group 4) -------------
    uv = torch.as_tensor(raster_selftest.sphere_uv(189, 189, TEX_SIZE,
                                                   TEX_SIZE), device=dev)
    tex = torch.as_tensor(np.random.RandomState(SEED + 3).rand(
        TEX_SIZE, TEX_SIZE, 3).astype(np.float32), device=dev)
    with torch.inference_mode():
        reset_counts()
        textured = {g: tops.render_texture_kernel(verts, tri, tex, uv, tri,
                                                  h=224, w=224, group=g)
                    for g in (0, 4)}
        torch.cuda.synchronize()
        tex_launched = counts()
        if (tex_launched["raster_interp"] != 1
                or tex_launched["raster_interp_grouped"] != 1
                or sum(tex_launched.values()) != 2):
            raise AssertionError(f"texture path launches {tex_launched}: "
                                 "K3 and K5 once each")
        want_tex = plain.render_texture(verts, tri, tex, uv, tri, 224, 224)
        want_w = plain.rasterize_winner_interp(verts, tri, 224, 224)
        tex_err = 0.0
        for g, (img, depth) in textured.items():
            winner, kdepth = tops.rasterize_winner_interp(verts, tri, 224,
                                                          224, group=g)
            raster_selftest.expect_equal(winner, want_w[0],
                                         f"texture group {g} winner")
            raster_selftest.expect_equal(kdepth, want_w[1],
                                         f"texture group {g} depth")
            raster_selftest.expect_equal(depth, want_tex[1],
                                         f"texture group {g} depth buffer")
            tex_err = max(tex_err, float((img - want_tex[0]).abs().max()))
        raster_selftest.expect_equal(textured[4][0], textured[0][0],
                                     "texture K5 == K3 image")
        if not tex_err <= 1e-5:
            raise AssertionError(f"texture image off the plain version by "
                                 f"{tex_err}")
        tex_std = float(textured[0][0].std())
    log(f"texture path: render_texture_kernel B={CHUNK} 224², "
        f"{TEX_SIZE}² texture, launches K3 "
        f"{tex_launched['raster_interp']} K5 "
        f"{tex_launched['raster_interp_grouped']}; winner/depth bit-exact, "
        f"image max |diff| {tex_err:.3g} (band 1e-5), K5 == K3, image std "
        f"{tex_std:.3g}")

    # ---- 6. K4, K3, K5 against their plain versions and bounds ----------
    with torch.inference_mode():
        k4_ms = cuda_ms(lambda: tops.render_colors_grouped(
            verts, colors, tri, h=224, w=224, group=4), 50, 5)
        p4g_ms = cuda_ms(lambda: plain.render_colors(
            verts, colors, tri, 224, 224, group=4), 5, 1)
        k3_ms = cuda_ms(lambda: tops.rasterize_winner_interp(
            verts, tri, 224, 224), 50, 5)
        p3_ms = cuda_ms(lambda: plain.rasterize_winner_interp(
            verts, tri, 224, 224), 5, 1)
        k5_ms = cuda_ms(lambda: tops.rasterize_winner_interp(
            verts, tri, 224, 224, group=4), 50, 5)
        p5_ms = cuda_ms(lambda: plain.rasterize_winner_interp(
            verts, tri, 224, 224, group=4), 5, 1)
        tex_ms = cuda_ms(lambda: tops.render_texture_kernel(
            verts, tri, tex, uv, tri, h=224, w=224), 20, 3)
        ibound, ibound_by, inbytes, iops = interp_bound_ms(verts, tri, 224,
                                                           224)
    log(f"raster B={CHUNK}: K4 group 4 {k4_ms:.4f} ms (plain "
        f"{p4g_ms:.4f} ms, bound {bound:.4f} ms as K1); K3 {k3_ms:.4f} ms "
        f"(plain {p3_ms:.4f} ms); K5 group 4 {k5_ms:.4f} ms (plain "
        f"{p5_ms:.4f} ms); interp bound {ibound:.4f} ms ({ibound_by}: "
        f"{inbytes} B, {iops} ops); render_texture_kernel total "
        f"{tex_ms:.4f} ms; {card}")

    # ---- 7. the probe path: X1-X3 and the A/B profile entry points ------
    t0 = time.perf_counter()
    probe_report = raster_selftest.run_probe_selftest(dev)
    torch.cuda.synchronize()
    log(f"probe parity: {len(probe_report)} cases bit-exact probe == plain "
        f"(X1 both modes, X2 at fb x unroll {probes.UNROLLS}, X3 at "
        f"{raster_selftest.REGACC_SETTINGS}; X1 == K1 off degenerate "
        f"winners; X3 == K1 on band_fitting) in "
        f"{time.perf_counter() - t0:.2f} s; pixels K1 gives degenerate "
        f"triangles: {json.dumps(probe_report)}")

    def probe_args(mesh):
        return argparse.Namespace(device=dev, batch=PROBE_BATCH, mesh=mesh)

    with torch.inference_mode():
        pv, ptri = probe_common.probe_mesh(probe_args(189), 0, 1)
        rv, rtri = probe_common.probe_mesh(probe_args(192), 7, 11)
        pk1 = plain.rasterize_winner(pv, ptri, 224, 224)
        raster_selftest.expect_equal(tops.rasterize_winner(pv, ptri, 224,
                                                           224)[0],
                                     pk1[0], "probe mesh K1 winner")
        x1_want = plain.rasterize_winner_inside_only(pv, ptri, 224, 224)
        x1 = probes.raster_b(pv, ptri, 224, 224)
        x1_depth = probes.raster_b(pv, ptri, 224, 224, winner=False)
        torch.cuda.synchronize()
        for got, want, part in ((x1[0], x1_want[0], "winner"),
                                (x1[1], x1_want[1], "depth"),
                                (x1_depth, x1_want[1], "depth-only")):
            raster_selftest.expect_equal(got, want, f"probe mesh X1 {part}")
        x1_deg = raster_selftest.expect_inside_only_matches_k1(
            x1[0], pk1[0], pv, ptri, "probe mesh")
        x1_err = float((x1[1] - x1_want[1]).abs().max())
        x2_err = 0.0
        for fb, unroll in profile_raster3.SETTINGS:
            x2 = probes.raster_u(pv, ptri, 224, 224, fb=fb, unroll=unroll)
            torch.cuda.synchronize()
            raster_selftest.expect_equal(x2[0], pk1[0],
                                         f"X2 fb {fb} unroll {unroll} winner")
            raster_selftest.expect_equal(x2[1], pk1[1],
                                         f"X2 fb {fb} unroll {unroll} depth")
            x2_err = max(x2_err, float((x2[1] - pk1[1]).abs().max()))
        rk1 = plain.rasterize_winner(rv, rtri, 224, 224)
        x3_err, x3_off_k1 = 0.0, {}
        for win, fb in raster_selftest.REGACC_SETTINGS:
            want = plain.rasterize_winner_banded(rv, rtri, 224, 224, win,
                                                 512 // fb)
            x3 = probes.rasterize_regacc(rv, rtri, 224, 224, win=win, fb=fb)
            torch.cuda.synchronize()
            raster_selftest.expect_equal(x3[0], want[0],
                                         f"X3 win {win} fb {fb} winner")
            raster_selftest.expect_equal(x3[1], want[1],
                                         f"X3 win {win} fb {fb} depth")
            x3_err = max(x3_err, float((x3[1] - want[1]).abs().max()))
            x3_off_k1[f"win{win}_fb{fb}"] = int((x3[0] != rk1[0]).sum())
    log(f"probe parity: B={PROBE_BATCH} 224², {ptri.shape[0]} triangles: "
        f"X1 == plain in both modes, == K1 off degenerate winners ({x1_deg} "
        f"px won by degenerate triangles in K1); X2 == K1 at (fb, unroll) "
        f"{profile_raster3.SETTINGS}; {rtri.shape[0]} triangles: X3 == "
        f"plain at {raster_selftest.REGACC_SETTINGS}, pixels off K1 "
        f"{json.dumps(x3_off_k1)}")

    # every profile entry point once at reduced rounds: each probe launches
    reset_counts()
    t0 = time.perf_counter()
    for mod in (profile_raster, profile_raster2, profile_raster3,
                profile_raster_regacc, profile_raster_grouped):
        mod.main(["--rounds", "1", "--k", "2"])
    torch.cuda.synchronize()
    probe_launched = counts()
    log(f"probe path: the five profile entry points (K = 2, one round) in "
        f"{time.perf_counter() - t0:.2f} s, launches "
        f"{json.dumps(probe_launched)}")
    if not all(probe_launched[k.name] > 0 for k in probes.PROBE_KERNELS):
        raise AssertionError(f"probe path launches {probe_launched}: every "
                             "probe must launch")

    with torch.inference_mode():
        deg = plain.degenerate(pv, ptri)
        p_live = pv[:, ptri.long(), 2].sum(-1) / 3.0 > -99999.0
        r_live = rv[:, rtri.long(), 2].sum(-1) / 3.0 > -99999.0
        x1_ms = cuda_ms(lambda: probes.raster_b(pv, ptri, 224, 224), 50, 5)
        x1d_ms = cuda_ms(lambda: probes.raster_b(pv, ptri, 224, 224,
                                                 winner=False), 50, 5)
        x1p_ms = cuda_ms(lambda: plain.rasterize_winner_inside_only(
            pv, ptri, 224, 224), 5, 1)
        pk1_ms = cuda_ms(lambda: tops.rasterize_winner(pv, ptri, 224, 224),
                         50, 5)
        x2_ms = {f"U{u}_fb{fb}": cuda_ms(lambda fb=fb, u=u: probes.raster_u(
            pv, ptri, 224, 224, fb=fb, unroll=u), 50, 5)
            for fb, u in profile_raster3.SETTINGS}
        x2p_ms = cuda_ms(lambda: plain.rasterize_winner(pv, ptri, 224, 224),
                         5, 1)
        rk1_ms = cuda_ms(lambda: tops.rasterize_winner(rv, rtri, 224, 224),
                         50, 5)
        x3_ms = {f"win{win}_fb{fb}": cuda_ms(
            lambda win=win, fb=fb: probes.rasterize_regacc(
                rv, rtri, 224, 224, win=win, fb=fb), 50, 5)
            for win, fb in raster_selftest.REGACC_SETTINGS}
        x3p_ms = cuda_ms(lambda: plain.rasterize_winner_banded(
            rv, rtri, 224, 224, 16, 64), 5, 1)
        x1_bound = probe_bound_ms(pv, ptri, 224, 224, 8, p_live & ~deg)
        x1d_bound = probe_bound_ms(pv, ptri, 224, 224, 4, p_live & ~deg)
        x2_bound = probe_bound_ms(pv, ptri, 224, 224, 8, p_live)
        starts = plain.band_origins(rv, rtri, 224, 16, 64)
        x3_bound = probe_bound_ms(
            rv, rtri, 224, 224, 8, r_live,
            band=(starts[:, torch.arange(rtri.shape[0], device=dev) // 64],
                  16))
    entries_p = PROBE_BATCH * ptri.shape[0]
    entries_r = PROBE_BATCH * rtri.shape[0]
    log(f"probe times B={PROBE_BATCH} 224², ms (ns per triangle-frame): "
        f"K1 {pk1_ms:.4f} ({pk1_ms / entries_p * 1e6:.3f}); X1 winner "
        f"{x1_ms:.4f} ({x1_ms / entries_p * 1e6:.3f}), depth-only "
        f"{x1d_ms:.4f} ({x1d_ms / entries_p * 1e6:.3f}), plain "
        f"{x1p_ms:.4f}, bound {x1_bound[0]:.4f} / depth-only "
        f"{x1d_bound[0]:.4f} ({x1_bound[1]}: {x1_bound[2]} B, {x1_bound[3]} "
        f"ops); X2 {json.dumps({k: round(v, 4) for k, v in x2_ms.items()})}"
        f", plain {x2p_ms:.4f}, bound {x2_bound[0]:.4f}; {card}")
    log(f"probe times B={PROBE_BATCH} 224², {rtri.shape[0]} triangles: K1 "
        f"{rk1_ms:.4f} ms ({rk1_ms / entries_r * 1e6:.3f} ns/tri-frame); X3 "
        f"{json.dumps({k: round(v, 4) for k, v in x3_ms.items()})} ms, "
        f"plain (win 16 fb 8) {x3p_ms:.4f}, bound {x3_bound[0]:.4f} "
        f"({x3_bound[1]}: {x3_bound[2]} B, {x3_bound[3]} ops); decision "
        f"K1 / X3 win16 fb8 = {rk1_ms / x3_ms['win16_fb8']:.3f} "
        f"(tile binning only at >= 1.3); {card}")

    # ---- 8. the card against the port on the CPU ------------------------
    cpu_bfm, cpu_g = trees
    cpu_synth = syn.Synthesizer(cfg, face_model, cpu_bfm, cpu_g,
                                chunk=CHUNK, gan_dtype=torch.float32,
                                device="cpu")
    exp_gpu = synth.predict_expressions(pcm).cpu().numpy()
    exp_cpu = cpu_synth.predict_expressions(pcm).numpy()
    exp_err = float(np.abs(exp_gpu - exp_cpu).max())
    # fp32 on both (TF32 off), other sum orders: ~1e-5 on O(0.1) coeffs
    if not exp_err < 2e-4:
        raise AssertionError(f"expression coefficients card vs CPU "
                             f"max |diff| {exp_err}")
    log(f"reference: full-width coefficients card vs CPU max |diff| "
        f"{exp_err:.3g} (band 2e-4)")
    del cpu_synth

    # the served generator (bf16 convs, fp32 BN moments and compositing)
    # against the same weights in float32 on the card, on the generator
    # inputs of the main path's first chunk; a bf16-moments generator is run
    # beside it to show the band tells the two apart
    captured = []
    hook = synth.gen.register_forward_hook(
        lambda mod, args, out: captured.append(args))
    with torch.inference_mode():
        synth.frame_program(geo, coeff, angles, bg, idx, ref, fg)
    hook.remove()
    gen32 = px.PixReferNet(cfg.pixrefer)
    gen32.load_state_dict(cpu_g)
    gen32.to(dev).eval()
    bn_forward = px.StatelessBatchNorm.forward
    with torch.inference_mode():
        want32 = gen32(*captured[0])[0]
        served = code_diff(synth.gen(*captured[0])[0], want32)
        px.StatelessBatchNorm.forward = bn_forward_bf16_moments
        try:
            control = code_diff(synth.gen(*captured[0])[0], want32)
        finally:
            px.StatelessBatchNorm.forward = bn_forward
    del gen32, want32, captured
    log(f"reference: bf16 generator vs float32, B={CHUNK} {s}² ngf "
        f"{cfg.pixrefer.ngf}, |diff| in codes: served mean {served[0]:.4g} "
        f"max {served[1]:.4g}; bf16 BN moments mean {control[0]:.4g} max "
        f"{control[1]:.4g} (band: mean < {GEN_BF16_MEAN_CODES})")
    if not served[0] < GEN_BF16_MEAN_CODES:
        raise AssertionError(f"bf16 generator off float32 by {served}")
    if not control[0] >= GEN_BF16_MEAN_CODES:
        raise AssertionError(f"the generator band misses bf16 BN moments "
                             f"{control}")

    small = tcfg.Config(
        bfmnet=tcfg.BFMNetConfig(backbone_width_mult=0.25,
                                 thinresnet_output_channels=64,
                                 encode_embedding_size=64,
                                 rnn_hidden_size=64),
        pixrefer=tcfg.PixReferConfig(ngf=8, img_size=256))
    small_model = bfm.synthetic_bfm(num_theta=40, num_phi=40, seed=1)
    sb, sg = syn.SynthesisAssets.init_trees(small, SEED + 1)
    ss = small.pixrefer.img_size
    s_pcm = pcm[:(21 - 1) * small.frame_wav_scale]     # 21 frames: 16 + 5
    s_panel = rng.rand(ss, 3 * ss, 3).astype(np.float32)
    ident = syn.synthetic_identity(small_model, img_size=ss)
    got = syn.Synthesizer(small, small_model, sb, sg, chunk=16,
                          gan_dtype=torch.float32).synthesize(
                              s_panel, s_pcm, ident)
    want = syn.Synthesizer(small, small_model, sb, sg, chunk=16,
                           gan_dtype=torch.float32, device="cpu").synthesize(
                               s_panel, s_pcm, ident)
    mean, over1, dmax = frame_diff(got, want)
    # fp32 sum-order noise and the rare raster pixel whose winner flips on
    # an ulp-level vertex difference (tests/test_torch_synthesize.py)
    if got.shape != want.shape or not (mean < 0.01 and over1 < 1e-3):
        raise AssertionError(f"small frames card vs CPU: mean {mean}, "
                             f"share > 1 code {over1}, max {dmax}")
    log(f"reference: small frames {got.shape} card vs CPU mean |diff| "
        f"{mean:.3g}, share > 1 code {over1:.3g}, max {dmax} "
        f"(bands 0.01, 1e-3)")

    pallas = "voicepuppet_tpu/ops/raster_pallas.py"
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "voicepuppet_torch/csrc/raster.cu",
        "replaces": replaces,
        "launches": n,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": pms,
        "bound_ms": bms,
        "bound_by": bby,
        "library_ms": None,
    } for name, replaces, n, err, ms, pms, bms, bby in (
        ("raster_flat", f"{pallas}:126", launches, max_abs_err, k_ms, p_ms,
         bound, bound_by),
        ("raster_grouped", f"{pallas}:337", k4_launches, k4_err, k4_ms,
         p4g_ms, bound, bound_by),
        ("raster_interp", f"{pallas}:695", tex_launched["raster_interp"],
         k3_err, k3_ms, p3_ms, ibound, ibound_by),
        ("raster_interp_grouped", f"{pallas}:769",
         tex_launched["raster_interp_grouped"], k5_err, k5_ms, p5_ms, ibound,
         ibound_by),
        ("probe_inside_only", "experiments/profile_raster2.py:49",
         probe_launched["probe_inside_only"], x1_err, x1_ms, x1p_ms,
         x1_bound[0], x1_bound[1]),
        ("probe_unroll", "experiments/profile_raster3.py:35",
         probe_launched["probe_unroll"], x2_err, x2_ms["U2_fb8"], x2p_ms,
         x2_bound[0], x2_bound[1]),
        ("probe_band_regacc", "experiments/profile_raster_regacc.py:49",
         probe_launched["probe_band_regacc"], x3_err, x3_ms["win16_fb8"],
         x3p_ms, x3_bound[0], x3_bound[1]))]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
