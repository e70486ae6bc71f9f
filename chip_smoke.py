#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (voicepuppet_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (found on PATH, under $CUDA_HOME or
/usr/local/cuda).  Phases, each of which fails the script on any fault:

  1. device and build   print the card's name and power limit; build the
                        raster kernels (csrc/raster.cu: flat K1, grouped K4
                        and K5 at each tile width, interpolated K3, the
                        probes X1-X3) into build/ and print ptxas's
                        registers and spills.
  2. raster parity      every CUDA kernel against its plain PyTorch version,
                        bit for bit, through every entry point: the quirk,
                        grouped and interp meshes of ops/raster_selftest.py,
                        then the full 189² synthetic mesh at 224² for one
                        32-frame chunk of the main path (K4 and K5 at each
                        of raster_selftest.GROUP_SIZES, K3), K4 against K1
                        and K5 against K3.
  2b. bn kernels        build csrc/norm.cu (the generators' batch norm,
                        ops/batchnorm.py) and run ops/batchnorm_selftest.py:
                        every BN shape of both served generators in bf16
                        and float32, each moment mode, channels_last
                        (moments within 1e-5 of float64 and bit-equal to
                        moments_plain, outputs byte-equal to eager
                        normalize of those moments); whole generators no
                        further from float32 than eager, with eager
                        reordered and the library's one-call batch norm
                        beside them; the vp.bn.* counters of a forward and
                        a training step; kernel, plain, eager and library
                        ms and the bound on the largest shapes.  Alone:
                        python3 -c "import torch, chip_smoke as c;
                        c.phase_bn(torch.device('cuda', 0), c.card_line())".
  3. main path          Config() (ngf 64, 512², BFMNet width 1.0),
                        synthetic_bfm(189, 189), chunk 32, random weights
                        from seed 0: Synthesizer.synthesize on 2.2 s of
                        audio (55 frames: one chunk of 32 and a tail bucket
                        of 32), the generator in bfloat16.  The flat raster
                        K1 must launch once per chunk, the batch norm
                        kernels once for every BN call of G.  Then frames/s
                        over timed repeats, a per-stage time breakdown of
                        one chunk.
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
                        at the shapes its path gives it; K4/K1 and K5/K3;
                        K1 beside X2 at unroll 1, fb 1 (K1's schedule in
                        the probe's kernel), bit for bit equal, and the
                        ratio "X2 (1,1) / K1"; one K1, K3 and X2 (1,1)
                        call each split into its device launches (memset,
                        pass 1, resolve) by torch.profiler, or a line
                        saying it recorded none; the walk steps on these
                        inputs (the CPU model of ops/raster_selftest.py).
  7. probe path         the raster A/B probes (ops/raster_probes.py): the
                        probe selftest on every quirk, grouped and interp
                        case and a band-fitting one; at the JAX profile
                        scripts' shapes (B = 16 at 224², the 189² and 192²
                        meshes) each probe bit for bit against its plain
                        version, X2 against K1 at (1, 1) and four settings,
                        X1 against K1 off degenerate winners (X1 on both
                        meshes: the 192²'s warps straddle frames); then every
                        profile entry point (voicepuppet_torch/experiments/)
                        once at K = 2 and one round, where every probe must
                        launch; probe times beside K1's, plain and bound
                        (X2 at (1, 1) and profile_raster3's settings, X3 at
                        raster_selftest.REGACC_SETTINGS), each X1 (both
                        modes), X2 and X3 launch's registers, shared bytes
                        and blocks an SM, and the probe's time over K1's;
                        one K1 and one X1 call in each mode split into its
                        device launches (torch.profiler); X1's walk steps
                        against K1's and X3's union rectangles against
                        whole bands (the CPU model).
  8. reference checks   the card against the port on the CPU (float32
                        everywhere): the full-width expression coefficients,
                        and whole frames at a small size (ngf 8, 256²); the
                        served bf16 generator against its float32 weights on
                        the card at full width, with a bf16-BN-moments
                        control that the band must reject.
  9. TF oracle          the TF-written BFMNet checkpoint of
                        tests/fixtures/tf_oracle/ (242 variables) through the
                        port's loader, on the card against TensorFlow's
                        coefficients: mean < 1e-4, max < 1e-3.
 10. released weights   the main path's weights written as V2 bundles and as
                        TF-named npz files (write_bundle, export_arrays),
                        loaded by from_tf_checkpoints and from_npz:
                        state_dicts equal the source, the 55 frames
                        byte-identical to the main path's, K1 once per
                        chunk; sizes, read time, frames/s.
 11. R-Net              ResNet-50 + 257 head at 224² from seeded weights (BN
                        moments calibrated on a random batch), written as a
                        frozen GraphDef and an npz, loaded by from_pb and
                        from_npz: the card against the CPU on a face photo's
                        crop (sat_alignment + align_for_identity), ms per
                        image, and that identity served through K1.
 12. serving leftovers  bfmnet_dtype=bfloat16 against float32 (0 < d < 0.05 x
                        scale + 1e-3, coefficient program ms of each); the
                        rgb8 and yuv420 drains at drain_workers 1 and 2
                        (frames/s, host ms per chunk; rgb8 luma within 1.5
                        codes of yuv420's); estimate_chunk_compute beside the
                        profiler's sum of the frame program; the corner-cache
                        decode against the gather decode (1e-5 of scale) and
                        the device ms of each.
 13. mesh video         infer_bfmnet: the 55-frame clip as a 672² mesh video,
                        K1 once per chunk of 8; K1 at 672², B = 8, bit for
                        bit against its plain version, its time, bound and
                        ratio.
 14. train bfmnet      BFMNetTrainer at Config() (width 1.0, 256-wide, batch 8,
                        T = 24, dropout 0.25, the loss through the 189²
                        synthetic BFM) on an on-disk dataset of 4 clips of
                        240 frames: fit 30 steps with eval and checkpoints
                        every 10, K1 twice per eval (the eval grid), the
                        last grid equal to the plain raster's bit for bit,
                        the checkpoint restored equal; ms per step (CUDA
                        events), fit steps/s, steps_per_call 4 against 1,
                        the device's idle share (torch.profiler).
 15. train pixrefer    PixReferTrainer at Config() (512², ngf 64, ndf 64,
                        batch 2, the full VGG-16 trunk from seed 17) on
                        512x1536 3-panel JPEG clips, float32,
                        perceptual_dtype bfloat16 and dtype bfloat16: the
                        image summary and a checkpoint from fit, then 10
                        timed steps each with their G forward + D / G split,
                        peak memory and the losses.
 16. train card vs cpu one BFMNet and one PixRefer step at the CPU tests'
                        widths on the card and on the CPU from the same
                        weights and batch: losses and gradients within the
                        CPU tests' bands, PixRefer's updates within 3e-3 of
                        a leaf's max, beside two readings that place that
                        band: the CPU against itself on the batch's rows
                        swapped, which must fall inside it, and the card
                        with TF32 on, which must fall outside it.
 17. from_checkpoints   the clip served from the checkpoint directories of
                        14 and 15, byte-identical to the same state_dicts
                        served directly, K1 once per chunk.
 18. pixflow            PixFlowTrainer at Config() (512², ngf 64, ndf 48,
                        batch 3) on 512x1536 3-panel JPEG clips: fit with a
                        checkpoint restored equal; ms per step in float32
                        and bfloat16 with the D / G split, peak memory, the
                        losses; infer_bfm_pixflow on the 55-frame clip (the
                        main path's BFMNet, K1 at 512² exactly once per 8
                        frames, 7 launches; 55 frames, not constant); K1 at
                        512², B = 8 bit for bit against its plain version,
                        its time, bound and ratio; infer_pixflow over one
                        clip's panels.
 19. atnet              ATNetTrainer at Config() (MfccNet width 1.0, batch
                        16, T 25, dropout 0.25) on coefficient / landmark /
                        wav clips: fit, ms per step, the device's idle share
                        over fit steps with the data pipeline, peak memory.
 20. vgnet              VGNetTrainer at Config() (128², batch 4, T 15) on
                        JPEG clips with landmarks, ``alternative`` 4: ms per
                        step of the D phase and of the G phase, peak memory;
                        infer_atvgnet on the 55-frame clip (ATNet of 19): 55
                        uint8 frames at 128².
 21. zoo card vs cpu    one SGD step of each of the three trainers at the
                        CPU tests' widths on the card and on the CPU from
                        the same weights and batch, dropout off: losses and
                        updates within the CPU tests' bands (every leaf at
                        1e-3 of its max update, true-zero leaves' |g| at
                        phase 16's 1e-5), the CPU's reading on the batch's
                        rows swapped inside the update band and the card's
                        with TF32 on outside it; VGNet's D scores.
 22. data parallel      BFMNet at Config() (B 8, T 24) and PixRefer at 512²
                        (ngf 64, batch 2): a world-1 NCCL group whose 3
                        Adam steps are bit-equal to the plain step's (cuDNN
                        deterministic, the plain step repeating itself as
                        the control); two spawned ranks sharing the card
                        over gloo: the averaged SGD gradients, every leaky
                        ReLU's and L1 term's kink frozen to the
                        single-process global-batch step's, within the CPU
                        tests' bands of that step's (BFMNet's zero-gradient
                        BN offsets by |g| under 1e-6 of the largest), twice
                        the average and a rank's own gradients outside
                        them; with the kinks free, the head outside only
                        where an input crossed a kink; the ranks'
                        parameters and buffers identical after a warm-up
                        and 3 timed Adam steps; ms per step.
 23. prep               prepare_dataset.Schedule steps 1, 5 (256²) and 6
                        (512x1536 panels, the segmentation and matting nets
                        at random init on the card) over a 40-frame clip of
                        the 189² synthetic BFM, then makelist: K1 exactly 3
                        times per render call (ceil(40/16)), the faces bit
                        for bit the plain raster's, the nets card vs CPU
                        within PREP_MODEL_BAND; wall seconds of each step.
 24. sharded serving    Synthesizer(mesh=, mesh_partition=) at Config() on
                        the 55-frame clip, chunk 32: a world-1 NCCL group
                        in both partitions byte-identical to the plain
                        Synthesizer (cuDNN deterministic); two spawned gloo
                        ranks sharing the card, "frames" and "spatial":
                        float32 + rgb8 within +-1 code (under 5% of values)
                        of one process, the serving default within
                        SHARD_SERVED_MEAN_CODES, a chunk of 16 and per-rank
                        BN moments outside it; K1 ceil(55/32) times per call
                        on each rank, on the rank's 16 frames ("frames") or
                        the whole 32 ("spatial"), bit for bit the plain
                        raster; wall ms per render_frames call (world 1
                        beside the plain Synthesizer; two gloo ranks on one
                        card) and a spatial stream's first block.
 25. experiments        every serving and training experiment of
                        voicepuppet_torch/experiments/ (profile_serving ...
                        profile_pixrefer_levers, streaming_quality) once at
                        full scale, K = 2, one round: each one's exactness
                        checks hold, its final table printed; K1 launches
                        in the frame-program ones.
 26. bench, graft entry voicepuppet_torch.bench.measure with the full
                        workload (8 s of audio, 201 frames, chunk 32) and a
                        30 s budget: raster_parity "ok", at least 4 runs,
                        finite frames/s, K1 7 times a call plus the
                        frame-rate probe's and the selftest's; the bench's
                        JSON line and the median of its runs; the
                        graft_entry frame step (K1 once, float32 G)
                        against Synthesizer.frame_program_for at float32
                        within 0.01 codes, the served bf16 program's
                        distance printed; the dryrun_multichip(2) of
                        graft_entry as two gloo ranks sharing the card.

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
ORACLE_MEAN, ORACLE_MAX = 1e-4, 1e-3   # tests/test_tf_oracle.py
# R-Net card vs CPU, both float32 (TF32 off): max |diff| over the scale of
# the coefficients; the CPU tests hold the port to JAX within 1e-5 of it
RNET_REL_BAND = 1e-4
RGB8_LUMA_MEAN = 1.5        # mean |luma(rgb8) - luma(yuv420)| in codes
CORNER_REL_BAND = 1e-5      # tests/test_torch_port_units.py
VIDEO_SIZE, VIDEO_CHUNK = 672, 8
TRAIN_STEPS, TRAIN_EVAL_EVERY = 30, 10   # BFMNet fit: 3 evals, 3 saves
PX_STEPS = 10                # timed PixRefer steps per dtype mode


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


def device_split(fn, calls=5):
    """The device launches of ``fn`` from torch.profiler with CUDA activity,
    over ``calls`` warm calls: {launch: (count, mean us)} in order of first
    appearance, or None when the profiler records no device event.  A
    measurement, not a gate."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in ("triangle_kernel", "unroll_walk_kernel",
                                 "inside_only_walk_kernel",
                                 "depth_resolve_kernel", "resolve_kernel",
                                 "Memset") if k in evt.name),
                    evt.name[:48])
        n, total = split.get(name, (0, 0.0))
        split[name] = (n + 1, total + evt.time_range.elapsed_us())
    return {k: (n, round(t / n, 3)) for k, (n, t) in split.items()} or None


def canvas_k1_check(coeff, fm, angles, size, launches, card):
    """K1 into the drivers' ``size``² canvas (``render_canvas``) against
    the plain raster and the bound: logged; the largest byte difference."""
    import torch
    from voicepuppet_torch import ops as tops
    from voicepuppet_torch.face3d import raster as plain
    from voicepuppet_torch.ops import raster_selftest
    from voicepuppet_torch.pipeline import synthesize as syn
    with torch.inference_mode():
        verts, colors = syn.canvas_mesh(coeff, fm, angles, size)
        tri = fm.tri
        got = syn.render_canvas(coeff, fm, angles, size)
        want = plain.render_colors(verts, colors, tri, size, size)
        torch.cuda.synchronize()
        raster_selftest.expect_equal(got[1], want[1], f"{size}² K1 mask")
        raster_selftest.expect_equal(got[0], want[0], f"{size}² K1 image")
        err = int((got[0].int() - want[0].int()).abs().max())
        k_ms = cuda_ms(lambda: tops.render_colors_auto(
            verts, colors, tri, h=size, w=size), 50, 5)
        p_ms = cuda_ms(lambda: plain.render_colors(
            verts, colors, tri, size, size), 3, 1)
        winner, _ = plain.rasterize_winner(verts, tri, size, size)
        bound, bound_by, nbytes, ops, _ = raster_bound_ms(
            verts, colors, tri, winner, size, size)
    log(f"raster {size}² B={coeff.shape[0]}: K1 bit-exact kernel == plain; "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms "
        f"({bound_by}: {nbytes} B, {ops} ops), kernel/bound "
        f"{k_ms / bound:.2f}; {launches}; {card}")
    return err


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



def phase_tf_oracle(dev):
    """9. The TF-written BFMNet checkpoint through the port's loader on the
    card, against the coefficients TensorFlow computed."""
    import numpy as np
    import torch
    from voicepuppet_torch.audio.frontend import full_fp32_matmuls
    from voicepuppet_torch.config import BFMNetConfig
    from voicepuppet_torch.models.bfmnet import BFMNet
    from voicepuppet_torch.tools import tf_checkpoint as tfc
    full_fp32_matmuls()
    fix = os.path.join(HERE, "tests", "fixtures", "tf_oracle")
    z = np.load(os.path.join(fix, "bfmnet.npz"))
    net = BFMNet(BFMNetConfig(thinresnet_output_channels=32,
                              encode_embedding_size=32, rnn_hidden_size=32,
                              backbone_width_mult=0.25))
    state, loaded, missing = tfc.load_bfmnet_ckpt(
        os.path.join(fix, "bfmnet_ckpt", "model-65000"), net)
    if missing or len(loaded) != 242:
        raise AssertionError(f"TF oracle checkpoint: {len(loaded)} loaded, "
                             f"missing {missing[:3]}")
    net.load_state_dict(state)
    net.to(dev).eval()
    with torch.inference_mode():
        out = net(*(torch.as_tensor(z[k], device=dev)
                    for k in ("ears", "mfccs", "seq_len"))).cpu().numpy()
    d = np.abs(out - z["coeff"])
    log(f"tf oracle: TF-written BFMNet checkpoint, {len(loaded)}/242 "
        f"variables, on the card vs TensorFlow's coefficients: mean |diff| "
        f"{d.mean():.3g} (band {ORACLE_MEAN}), max {d.max():.3g} (band "
        f"{ORACLE_MAX})")
    if not (d.mean() < ORACLE_MEAN and d.max() < ORACLE_MAX):
        raise AssertionError(f"TF oracle off by mean {d.mean()} max "
                             f"{d.max()}")


def phase_released_weights(cfg, face_model, trees, panel, pcm, identity,
                           want_frames, counts, reset_counts, n_chunks,
                           card):
    """10. Full-width weights written as the reference ships them (a V2
    bundle per model) and as TF-named npz files, loaded through
    from_tf_checkpoints and from_npz: the state_dicts equal the source
    tensor for tensor, the frames equal the source Synthesizer's byte for
    byte."""
    import tempfile
    import numpy as np
    import torch
    from voicepuppet_torch.pipeline import synthesize as syn
    from voicepuppet_torch.tools import tf_bundle as tb
    from voicepuppet_torch.tools import tf_checkpoint as tfc
    bfm_state, g_state = trees
    arrays = {"bfmnet": tfc.export_arrays(bfm_state,
                                          tfc.bfmnet_rows(bfm_state)),
              "pixrefer": tfc.export_arrays(
                  g_state, tfc.pixrefer_generator_name_map())}
    with tempfile.TemporaryDirectory() as td:
        prefix, npz, sizes = {}, {}, {}
        t0 = time.perf_counter()
        for name, arr in arrays.items():
            prefix[name] = os.path.join(td, f"ckpt_{name}", f"{name}-1")
            tb.write_bundle(arr, prefix[name])
            npz[name] = os.path.join(td, f"{name}.npz")
            np.savez(npz[name], **{k.replace("/", "|"): v
                                   for k, v in arr.items()})
            sizes[name] = round(sum(
                os.path.getsize(os.path.join(os.path.dirname(prefix[name]),
                                             f)) for f in os.listdir(
                    os.path.dirname(prefix[name]))) / 1e6, 3)
        write_s = time.perf_counter() - t0
        loads = {}
        for source in ("tf", "npz"):
            t0 = time.perf_counter()
            if source == "tf":
                states = syn.SynthesisAssets.load_tf_weights(
                    cfg, prefix["bfmnet"], prefix["pixrefer"])
            else:
                states = syn.SynthesisAssets.load_npz_weights(
                    cfg, npz["bfmnet"], npz["pixrefer"])
            loads[source] = time.perf_counter() - t0
            for got, want, what in ((states[0], bfm_state, "bfmnet"),
                                    (states[1], g_state, "generator")):
                if set(got) != set(want) or not all(
                        torch.equal(got[k], want[k]) for k in want):
                    raise AssertionError(f"{source} {what} state_dict "
                                         "differs from the source")
            t0 = time.perf_counter()
            synth = (syn.SynthesisAssets.from_tf_checkpoints(
                cfg, prefix["bfmnet"], prefix["pixrefer"],
                face_model=face_model, chunk=CHUNK) if source == "tf" else
                syn.SynthesisAssets.from_npz(
                    cfg, npz["bfmnet"], npz["pixrefer"],
                    face_model=face_model, chunk=CHUNK))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            reset_counts()
            got_frames = synth.synthesize(panel, pcm, identity)
            launched = counts()
            if (launched["raster_flat"] != n_chunks
                    or raster_launches(launched) != n_chunks):
                raise AssertionError(f"{source} path launches {launched}")
            if not np.array_equal(got_frames, want_frames):
                d = np.abs(got_frames.astype(np.int16)
                           - want_frames.astype(np.int16))
                raise AssertionError(f"{source} frames differ from the "
                                     f"source Synthesizer's: max {d.max()}, "
                                     f"{int((d > 0).sum())} values")
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                synth.synthesize(panel, pcm, identity)
                times.append(time.perf_counter() - t0)
            synth.close()
            del synth
            fps = sorted(FRAMES / t for t in times)
            log(f"released weights ({source}): state_dicts equal the "
                f"source tensor for tensor, {FRAMES} frames byte-identical "
                f"to the source Synthesizer's, K1 launches "
                f"{launched['raster_flat']}; read {loads[source]:.3f} s, "
                f"Synthesizer built in {build_s:.3f} s; frames/s "
                f"{json.dumps([round(f, 2) for f in fps])} (median "
                f"{fps[1]:.2f}), {card}")
    log(f"released weights: bundles bfmnet {sizes['bfmnet']} MB, pixrefer "
        f"G {sizes['pixrefer']} MB (ngf {cfg.pixrefer.ngf}, "
        f"{cfg.pixrefer.img_size}²), written with npz twins in "
        f"{write_s:.3f} s")


def phase_rnet(cfg, synth, panel, pcm, dev, counts, reset_counts,
               n_chunks, card):
    """11. The R-Net at full width (ResNet-50 at 224²) from a frozen
    GraphDef and an npz of seeded weights: the card against the CPU, then
    a face photo's identity served through K1."""
    import tempfile
    import numpy as np
    import torch
    from voicepuppet_torch.pipeline import detect, rnet
    from voicepuppet_torch.tools import tf_bundle as tb
    gen = torch.Generator().manual_seed(SEED + 5)
    calib = torch.rand((2, 224, 224, 3), generator=gen) * 255.0
    net = rnet.init_rnet_(rnet.RNet(), gen, calib)
    arrays = rnet.export_rnet_arrays(net.state_dict())
    lm3d = np.random.RandomState(SEED + 6).randn(5, 3) * 0.3
    s = cfg.pixrefer.img_size
    photo = panel[:, :s]
    with tempfile.TemporaryDirectory() as td:
        pb = os.path.join(td, "FaceReconModel.pb")
        tb.write_graphdef_consts(arrays, pb)
        np.savez(os.path.join(td, "rnet.npz"),
                 **{k.replace("/", "|"): v for k, v in arrays.items()})
        on_card = rnet.RNetIdentityProvider.from_pb(pb, lm3d, device=dev)
        from_npz = rnet.RNetIdentityProvider.from_npz(
            os.path.join(td, "rnet.npz"), lm3d, device=dev)
        on_cpu = rnet.RNetIdentityProvider.from_pb(pb, lm3d, device="cpu")
        pb_mb = os.path.getsize(pb) / 1e6
    for a, b in zip(on_card.model.state_dict().values(),
                    from_npz.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError("R-Net from_pb and from_npz differ")
    aligned = detect.sat_alignment(photo, detect.CenteredFaceProvider())
    ident = on_card(*aligned[2:])
    want = on_cpu(*aligned[2:])
    scale = float(np.abs(want.bfmcoeff).max())
    err = float(np.abs(ident.bfmcoeff - want.bfmcoeff).max())
    if not (np.isfinite(ident.bfmcoeff).all()
            and err <= RNET_REL_BAND * max(scale, 1.0)):
        raise AssertionError(f"R-Net card vs CPU max |diff| {err} at scale "
                             f"{scale}")
    x = torch.rand((1, 224, 224, 3), generator=gen).to(dev) * 255.0
    with torch.inference_mode():
        ms = cuda_ms(lambda: on_card.model(x), 20, 3)
    log(f"rnet: ResNet-50 + 257 head at 224², {pb_mb:.1f} MB GraphDef, "
        f"from_pb == from_npz; card vs CPU max |diff| {err:.3g} on "
        f"coefficients of scale {scale:.3g} (band {RNET_REL_BAND} x "
        f"max(scale, 1)); {ms:.4f} ms per image (B = 1), {card}")
    reset_counts()
    frames = synth.synthesize(panel, pcm, ident)
    launched = counts()
    if (launched["raster_flat"] != n_chunks
            or raster_launches(launched) != n_chunks):
        raise AssertionError(f"R-Net identity path launches {launched}")
    if frames.shape != (FRAMES, s, s, 3) or not frames.std(axis=0).max() > 0:
        raise AssertionError(f"R-Net identity frames {frames.shape}")
    transform = np.round(ident.transform_params, 3).tolist()
    log(f"rnet: the photo's identity (colors_bgr {ident.colors_bgr}, ratio "
        f"{ident.ratio:.4f}, transform {transform}) served: {frames.shape} "
        f"{frames.dtype}, K1 launches {launched['raster_flat']}")


def phase_leftovers(cfg, face_model, trees, synth, identity, panel, pcm,
                    dev, frame_program_ms, card):
    """12. bfmnet_dtype, the rgb8 and yuv420 drains at 1 and 2 workers,
    estimate_chunk_compute, and the corner-cache decode."""
    import numpy as np
    import torch
    from voicepuppet_torch.face3d import morph
    from voicepuppet_torch.pipeline import synthesize as syn
    from voicepuppet_torch.pipeline.align import head_sway_angles
    s = cfg.pixrefer.img_size

    def zero_chunk(sy):
        """One chunk of zero inputs through ``sy``'s frame program."""
        return sy.frame_program_for(identity)(
            torch.zeros((CHUNK, 257), device=dev),
            torch.zeros((CHUNK, 3), device=dev),
            torch.zeros((1, s, s, 3), device=dev),
            torch.zeros((CHUNK,), dtype=torch.int64, device=dev),
            torch.zeros((s, s, 3), device=dev),
            torch.zeros((s, s, 3), device=dev))

    synth16 = syn.Synthesizer(cfg, face_model, *trees, chunk=CHUNK,
                              bfmnet_dtype=torch.bfloat16)
    with torch.inference_mode():
        c32 = synth.predict_expressions(pcm)
        c16 = synth16.predict_expressions(pcm)
        ms32 = cuda_ms(lambda: synth.predict_expressions(pcm), 5)
        ms16 = cuda_ms(lambda: synth16.predict_expressions(pcm), 5)
    d = float((c32 - c16).abs().max())
    scale = float(c32.abs().max())
    log(f"bfmnet dtype: bfloat16 trunk vs float32, whole clip of {FRAMES} "
        f"frames: max |diff| {d:.4g} (band 0 < d < 0.05 x {scale:.4g} + "
        f"1e-3); coefficient program {ms32:.4f} ms float32, {ms16:.4f} ms "
        f"bfloat16, {card}")
    if not 0.0 < d < 0.05 * scale + 1e-3:
        raise AssertionError(f"bf16 coefficients off by {d} at {scale}")
    del synth16

    drained, rates = {}, {}
    for fmt in syn.TRANSFER_FORMATS:
        for workers in (1, 2):
            with syn.Synthesizer(cfg, face_model, *trees, chunk=CHUNK,
                                 transfer_format=fmt,
                                 drain_workers=workers) as sy:
                drained[fmt] = sy.synthesize(panel, pcm, identity)
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    sy.synthesize(panel, pcm, identity)
                    times.append(time.perf_counter() - t0)
                with torch.inference_mode():
                    out = zero_chunk(sy).cpu().numpy()
                host = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    sy.fetch_frames(out, CHUNK)
                    host.append(time.perf_counter() - t0)
            fps = sorted(FRAMES / t for t in times)
            rates[f"{fmt}_w{workers}"] = fps[1]
            log(f"drain {fmt}, drain_workers {workers}: frames/s "
                f"{json.dumps([round(f, 2) for f in fps])} (median "
                f"{fps[1]:.2f}), host fetch_frames {min(host) * 1e3:.2f} ms "
                f"per chunk of {CHUNK} ({out.nbytes / 1e6:.2f} MB), {card}")
    luma = lambda f: f.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    dl = np.abs(luma(drained["rgb8"]) - luma(drained["yuv420"]))
    dc = np.abs(drained["rgb8"].astype(np.int16)
                - drained["yuv420"].astype(np.int16))
    log(f"drain rgb8 vs yuv420 frames: luma mean |diff| {dl.mean():.4f} "
        f"(band {RGB8_LUMA_MEAN}), max {dl.max():.2f}; RGB mean |diff| "
        f"{dc.mean():.4f}, max {dc.max()} (chroma subsampling)")
    if not dl.mean() < RGB8_LUMA_MEAN:
        raise AssertionError(f"rgb8 luma off yuv420 by {dl.mean()}")

    est = synth.estimate_chunk_compute(identity, k=4, repeats=3)
    split = device_split(lambda: zero_chunk(synth), calls=3)
    prof_ms = (sum(n * us for n, us in split.values()) / 3 / 1e3
               if split else float("nan"))
    log(f"estimate_chunk_compute: {est * 1e3:.4f} ms per chunk of {CHUNK} "
        f"(k = 4, 3 repeats, CUDA events); torch.profiler sum of the frame "
        f"program's device launches {prof_ms:.4f} ms; CUDA-event frame "
        f"program {frame_program_ms:.4f} ms; {card}")
    if not (np.isfinite(est) and est > 0):
        raise AssertionError(f"estimate_chunk_compute {est}")

    fm_cc = morph.device_bfm(face_model, dev, corner_cache=True)
    cache_mb = sum(t.numel() * 4 for t in (
        fm_cc.corner_id_base, fm_cc.corner_ex_base, fm_cc.corner_mean)) / 1e6
    with torch.inference_mode():
        coeff = syn.splice_coeff_sequence(identity.bfmcoeff,
                                          synth.predict_expressions(pcm)
                                          )[:CHUNK]
        angles = torch.as_tensor(head_sway_angles(CHUNK), device=dev)
        got = morph.reconstruct_rotation(coeff, fm_cc, angles)
        want = morph.reconstruct_rotation(coeff, synth.fm, angles)
        errs = {}
        for name in got._fields:
            a, b = getattr(got, name), getattr(want, name)
            errs[name] = float((a - b).abs().max()) / max(
                1.0, float(b.abs().max()))
        gather_ms = cuda_ms(lambda: morph.reconstruct_rotation(
            coeff, synth.fm, angles), 20, 3)
        cache_ms = cuda_ms(lambda: morph.reconstruct_rotation(
            coeff, fm_cc, angles), 20, 3)
        ngather = cuda_ms(lambda: morph.compute_norm(morph.shape_formation(
            coeff[:, :80], coeff[:, 80:144], synth.fm), synth.fm), 20, 3)
        ncache = cuda_ms(lambda: morph.compute_norm_from_coeff(
            coeff[:, :80], coeff[:, 80:144], fm_cc), 20, 3)
    worst = max(errs.values())
    log(f"corner cache: {cache_mb:.1f} MB on the card; reconstruct_rotation "
        f"B={CHUNK} cache vs gather max |diff| / max(1, scale) {worst:.3g} "
        f"(band {CORNER_REL_BAND}): "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}; "
        f"decode {gather_ms:.4f} ms gather, {cache_ms:.4f} ms cache; "
        f"normals alone {ngather:.4f} / {ncache:.4f} ms; {card}")
    if not worst <= CORNER_REL_BAND:
        raise AssertionError(f"corner-cache decode off by {errs}")
    del fm_cc


def phase_mesh_video(cfg, synth, identity, pcm, dev, counts, reset_counts,
                     card):
    """13. infer_bfmnet: the 55-frame clip as a 672² mesh video through K1
    in chunks of 8; K1 against its plain version at 672², B = 8."""
    import tempfile
    import torch
    from voicepuppet_torch.pipeline import infer_drivers
    from voicepuppet_torch.pipeline import synthesize as syn
    n_video = -(-FRAMES // VIDEO_CHUNK)
    with tempfile.TemporaryDirectory() as td:
        reset_counts()
        t0 = time.perf_counter()
        frames = infer_drivers.infer_bfmnet(cfg, synth, identity, pcm,
                                            out_dir=td, img_size=VIDEO_SIZE,
                                            chunk=VIDEO_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        wrote = sorted(os.listdir(td))
    if (launched["raster_flat"] != n_video
            or raster_launches(launched) != n_video):
        raise AssertionError(f"mesh video launches {launched}: K1 once per "
                             f"chunk of {VIDEO_CHUNK}")
    if (frames.shape != (FRAMES, VIDEO_SIZE, VIDEO_SIZE, 3)
            or not frames.std(axis=0).max() > 0):
        raise AssertionError(f"mesh video frames {frames.shape}")
    log(f"mesh video: infer_bfmnet -> {frames.shape} {frames.dtype} in "
        f"{wall:.3f} s, K1 launches {launched['raster_flat']} "
        f"(ceil({FRAMES}/{VIDEO_CHUNK})), covered "
        f"{float((frames.sum(-1) > 0).mean()):.3f} of pixels, wrote "
        f"{wrote[:3]}")
    with torch.inference_mode():
        exp = infer_drivers.predict_blink_expressions(cfg, synth, pcm)
        coeff = syn.splice_coeff_sequence(identity.bfmcoeff,
                                          exp)[:VIDEO_CHUNK]
        ang = torch.zeros((VIDEO_CHUNK, 3), device=dev)
        ang[:, 1] = torch.as_tensor(infer_drivers.sweep_yaw(VIDEO_CHUNK),
                                    device=dev)
    canvas_k1_check(coeff, synth.fm, ang, VIDEO_SIZE,
                    f"{n_video} launches per infer_bfmnet call", card)


# ---- 14-17. training ---------------------------------------------------------

def mark():
    """A CUDA event recorded on the current stream."""
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def elapsed_ms(a, b):
    b.synchronize()
    return a.elapsed_time(b)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def step_ms(fn, warm, n):
    """Median ms per call of ``fn`` over ``n`` calls after ``warm``: a mark
    before each call and one after the last, read after the last call, so
    the host may run ahead of the card."""
    for _ in range(warm):
        fn()
    marks = [mark()]
    for _ in range(n):
        fn()
        marks.append(mark())
    return median([elapsed_ms(a, b) for a, b in zip(marks, marks[1:])])


def device_busy_share(fn):
    """The share of a window's wall time in which the card ran a kernel,
    a copy or a memset: the union of their spans in a torch.profiler trace
    of ``fn``.  A trace with no device span, or a union longer than the
    window, is a fault of the measurement and raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("device_busy_share: the trace holds no device "
                             "span")
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if busy > wall_us:
        raise AssertionError(f"device_busy_share: {busy:.1f} us of device "
                             f"spans in a {wall_us:.1f} us window")
    return busy / wall_us


class _FetchAll:
    """A logger that keeps nothing: ``fit`` still fetches every step's
    metrics from the card to hand them to it, as with a real logger."""

    def log(self, *args, **kwargs):
        pass


def write_bfm_dataset(root, rng, clips, frames):
    """BFMNet clips as tests/test_trainer_clis.py writes them (coefficient
    and landmark text files, a 16 kHz wav), with 0.1 s of leading
    silence; returns the "folder|frame_count" list file."""
    import numpy as np
    from scipy.io import wavfile
    lines = []
    for k in range(clips):
        d = os.path.join(root, f"clip{k}")
        os.makedirs(d)
        np.savetxt(os.path.join(d, "bfmcoeff.txt"),
                   rng.randn(frames, 257) * 0.1, fmt="%.5f", delimiter=",")
        np.savetxt(os.path.join(d, "landmark.txt"),
                   rng.rand(frames, 136) * 140 + 40, fmt="%.3f",
                   delimiter=",")
        n = frames * 640
        t = np.arange(n) / 16000.0
        pcm = (0.3 * np.sin(2 * np.pi * (150 + 40 * k) * t)
               * np.sin(2 * np.pi * 3 * t) + 0.05 * rng.randn(n))
        pcm[:1600] = 0.0
        wavfile.write(os.path.join(d, "audio.wav"), 16000,
                      (np.clip(pcm, -1, 1) * 32767).astype(np.int16))
        lines.append(f"{d}|{frames}")
    path = os.path.join(root, "bfm_list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_panel_dataset(root, rng, clips, frames, s):
    """PixRefer clips of [s, 3s] target|render|alpha JPEG panels."""
    import numpy as np
    from PIL import Image
    lines = []
    for k in range(clips):
        d = os.path.join(root, f"panels{k}")
        os.makedirs(d)
        for i in range(frames):
            alpha = np.zeros((s, s, 3), np.uint8)
            alpha[s // 8:-s // 8, s // 4:-s // 4] = 255
            img = np.concatenate([(rng.rand(s, s, 3) * 255).astype(np.uint8),
                                  (rng.rand(s, s, 3) * 255).astype(np.uint8),
                                  alpha], axis=1)
            Image.fromarray(img).save(os.path.join(d, f"{i}.jpg"))
        lines.append(f"{d}|{frames}")
    path = os.path.join(root, "panel_list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


class plain_raster:
    """Within the block, ``ops.render_colors_auto`` is the plain PyTorch
    raster (face3d/raster.py) on the same tensors."""

    def __enter__(self):
        from voicepuppet_torch import ops
        from voicepuppet_torch.face3d import raster as plain
        self._saved = ops.render_colors_auto
        ops.render_colors_auto = (lambda v, c, t, h=224, w=224, **_:
                                  plain.render_colors(v, c, t, h, w))

    def __exit__(self, *exc):
        from voicepuppet_torch import ops
        ops.render_colors_auto = self._saved


def same_state(a, b, what):
    """Two state_dicts (tensors, or optimizer states) equal to the bit."""
    import torch

    def walk(x, y, path):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.shape == y.shape
                    and torch.equal(x.cpu(), y.cpu())):
                raise AssertionError(f"{what}: {path} differs")
        elif isinstance(x, dict):
            if set(x) != set(y):
                raise AssertionError(f"{what}: keys differ at {path}")
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}/{i}")
        elif x != y:
            raise AssertionError(f"{what}: {path} {x} != {y}")
    walk(a, b, "")


def phase_train_bfmnet(dev, counts, reset_counts, card, work):
    """14. BFMNet training at full width (Config(): width 1.0, 256-wide,
    batch 8, T = 24, dropout 0.25; the loss through the 189² synthetic
    BFM) on an on-disk dataset: fit with eval and checkpoints inside the
    run, the eval grid through K1 against the plain raster bit for bit,
    the checkpoint restored equal, ms per step, steps/s and the device's
    idle share."""
    import dataclasses
    import numpy as np
    import torch
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.data.generators import (BFMNetBatcher, FileSource,
                                                   prefetch_to_device)
    from voicepuppet_torch.face3d import bfm, morph
    from voicepuppet_torch.train.bfmnet_trainer import (BFMNetTrainer,
                                                        batch_to_device)
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    from voicepuppet_torch.train.metrics import MetricsLogger
    from voicepuppet_torch.utils.viz import coeff_grid, plot_bfm_coeff_seq
    steps, every, timed = TRAIN_STEPS, TRAIN_EVAL_EVERY, 20
    os.makedirs(work, exist_ok=True)
    lst = write_bfm_dataset(work, np.random.RandomState(SEED), 4, 240)
    cfg = tcfg.Config()
    b = cfg.bfmnet
    cfg = dataclasses.replace(
        cfg, dataset=dataclasses.replace(cfg.dataset, train_dataset_path=lst,
                                         eval_dataset_path=lst),
        bfmnet=dataclasses.replace(b, training=dataclasses.replace(
            b.training, eval_interval=every, save_interval=every,
            max_to_keep=2)))
    face_model = bfm.synthetic_bfm(num_theta=189, num_phi=189)
    trainer = BFMNetTrainer(cfg, face_model, device=dev)
    state = trainer.init_state(seed=SEED)
    fm = morph.device_bfm(face_model, dev)
    ckpt_dir = os.path.join(work, "ckpt_bfmnet")
    ckpt = CheckpointManager(ckpt_dir, 2, every)
    log_dir = os.path.join(work, "log_bfmnet")
    logger = MetricsLogger(log_dir, "bfmnet", print_every=0)
    evals = []

    def eval_hook(step, _state, batch, out):
        evals.append((np.asarray(batch[0][0]), out[0].cpu().numpy()))
        plot_bfm_coeff_seq(os.path.join(log_dir, "eval"), step,
                           *evals[-1], fm)

    batches = prefetch_to_device(iter(BFMNetBatcher(
        cfg, FileSource(lst, cfg), device=dev)), dev)
    eval_batches = iter(BFMNetBatcher(cfg, FileSource(lst, cfg),
                                      shuffle=False, device=dev))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.fit(state, batches, steps, eval_batches, logger, ckpt,
                        eval_hook=eval_hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    logger.close()
    n_grid = 2 * (steps // every)
    if (launched["raster_flat"] != n_grid
            or raster_launches(launched) != n_grid):
        raise AssertionError(f"bfmnet fit launches {launched}: K1 twice per "
                             f"eval, {steps // every} evals")
    with open(logger.path) as f:
        rows = [json.loads(x) for x in f]
    losses = [r["loss"] for r in rows if "loss" in r]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"bfmnet losses {losses}")
    real, pred = evals[-1]
    grid = coeff_grid(real, pred, fm)
    with plain_raster():
        want = coeff_grid(real, pred, fm)
    if not (np.array_equal(grid, want) and grid.max() > 0):
        raise AssertionError("eval grid: K1 differs from the plain raster")
    if ckpt.steps() != [steps - every, steps]:
        raise AssertionError(f"bfmnet checkpoints {ckpt.steps()}")
    restored = ckpt.restore(trainer.init_state(seed=SEED + 1))
    same_state(restored.state_dict(), state.state_dict(), "bfmnet restore")
    log(f"train bfmnet: Config() width {b.backbone_width_mult}, "
        f"{b.thinresnet_output_channels}/{b.encode_embedding_size}/"
        f"{b.rnn_hidden_size}, batch {b.batch_size}, T "
        f"{cfg.dataset.fixed_sequence_len}, dropout {b.training.drop_rate}, "
        f"loss basis {face_model.num_vertices} vertices; fit {steps} steps "
        f"(eval and save every {every}) in {wall:.2f} s = "
        f"{steps / wall:.2f} steps/s with the data pipeline; loss "
        f"{losses[0]:.4g} -> {losses[-1]:.4g} (finite); eval grid "
        f"{grid.shape} K1 == plain bit for bit, K1 launches "
        f"{launched['raster_flat']} ({n_grid // (steps // every)} per eval "
        f"at B = {real.shape[0]}, 224²); checkpoint {ckpt.steps()[-1]} "
        f"restored equal; {card}")

    batch = batch_to_device(next(batches), dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    ms = step_ms(lambda: trainer.train_step(state, batch, gen), 5, timed)

    def repeat():
        while True:
            yield batch

    per_call = {}
    for k in (1, 4, 1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(state, repeat(), 12, logger=_FetchAll(),
                    steps_per_call=k)
        torch.cuda.synchronize()
        per_call.setdefault(k, []).append(
            (time.perf_counter() - t0) / 12 * 1e3)
    busy = device_busy_share(lambda: trainer.fit(state, batches, 5))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train bfmnet: {ms:.3f} ms/step median over {timed} steps after 5 "
        f"warm (CUDA events, one device batch); fit ms/step at "
        f"steps_per_call 1 {min(per_call[1]):.3f}, 4 {min(per_call[4]):.3f} "
        f"(12 steps, metrics fetched per call, best of 2); device idle "
        f"share over 5 fit steps with the data pipeline {1 - busy:.3f}; peak "
        f"memory of the timed steps {peak:.2f} GiB; {card}")
    return dict(ckpt_dir=ckpt_dir, grid_launches=launched["raster_flat"])


PX_MODES = (("float32", "float32", None), ("perceptual_bf16", "float32",
                                           "bfloat16"),
            ("bf16", "bfloat16", None))


def phase_train_pixrefer(dev, card, work):
    """15. PixRefer training at full width (512², ngf 64, ndf 64, batch 2,
    the full VGG-16 trunk drawn from seed 17) on 3-panel JPEG clips, in
    float32, --perceptual_dtype bfloat16 and --dtype bfloat16: the image
    summary and a checkpoint from fit, then ms per step with its D / G
    split, peak memory and the losses."""
    import dataclasses
    import numpy as np
    import torch
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.data.generators import (BackgroundBatches,
                                                   FileSource,
                                                   PixReferBatcher,
                                                   prefetch_to_device)
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    from voicepuppet_torch.train.metrics import MetricsLogger
    from voicepuppet_torch.train.pixrefer_trainer import (DTYPES,
                                                          PixReferTrainer)
    steps, warm = PX_STEPS, 3
    os.makedirs(work, exist_ok=True)
    cfg = tcfg.Config()
    s = cfg.pixrefer.img_size
    lst = write_panel_dataset(work, np.random.RandomState(SEED + 1), 2, 6, s)
    p = cfg.pixrefer
    fit_steps = 5                      # global step 10: summary + save
    cfg = dataclasses.replace(
        cfg, dataset=dataclasses.replace(cfg.dataset,
                                         train_dataset_path=lst),
        pixrefer=dataclasses.replace(p, training=dataclasses.replace(
            p.training, summary_interval=2 * fit_steps,
            save_interval=2 * fit_steps)))
    src = FileSource(lst, cfg, load_images=True)
    ckpt_dir = os.path.join(work, "ckpt_pixrefer")
    for mode, dtype, pdtype in PX_MODES:
        trainer = PixReferTrainer(cfg, train_dtype=DTYPES[dtype],
                                  perceptual_dtype=DTYPES.get(pdtype),
                                  device=dev)
        state = trainer.init_state(seed=SEED)
        bg = BackgroundBatches(lambda i: iter(PixReferBatcher(
            cfg, src, seed=i)), num_workers=4)
        batches = prefetch_to_device(bg, dev)
        try:
            torch.cuda.reset_peak_memory_stats()
            if mode == "float32":
                log_dir = os.path.join(work, "log_pixrefer")
                logger = MetricsLogger(log_dir, "pixrefer", print_every=0)
                ckpt = CheckpointManager(ckpt_dir, 2,
                                         cfg.pixrefer.training.save_interval)
                state = trainer.fit(state, batches, fit_steps, logger, ckpt)
                logger.close()
                image = os.path.join(log_dir, "images",
                                     f"pixrefer_{2 * fit_steps}.jpg")
                if not os.path.exists(image) or ckpt.steps() != [
                        2 * fit_steps]:
                    raise AssertionError(f"pixrefer fit wrote {image} "
                                         f"{os.path.exists(image)}, "
                                         f"checkpoints {ckpt.steps()}")
            timed = [next(batches) for _ in range(warm + steps)]
        finally:
            bg.close()
        # timed with the decode threads stopped: their GIL time would slow
        # the host's launches inside the marks
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for i, batch in enumerate(timed):
            marks = []
            state, m = trainer.train_step(state, batch, marks=marks)
            if i >= warm:
                rows.append((marks, m))
        torch.cuda.synchronize()
        split = [[elapsed_ms(mk[0], mk[1]), elapsed_ms(mk[1], mk[2])]
                 for mk, _ in rows]
        losses = [{k: float(v) for k, v in m.items()} for _, m in rows]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(np.isfinite(list(r.values())).all() for r in losses):
            raise AssertionError(f"pixrefer {mode} losses {losses}")
        total = [d + g for d, g in split]
        k = total.index(median(total))
        log(f"train pixrefer {mode}: {s}² ngf {p.ngf} ndf {p.ndf} batch "
            f"{p.batch_size}, {median(total):.2f} ms/step median over {steps} "
            f"steps after {warm} warm on batches from the pipeline, its "
            f"threads stopped (G forward + D step {split[k][0]:.2f}, G step "
            f"{split[k][1]:.2f}; CUDA events); peak memory {peak:.2f} GiB; "
            f"last losses {json.dumps({n: round(v, 5) for n, v in losses[-1].items()})}"
            f"{'; wrote ' + image if mode == 'float32' else ''}; {card}")
        del trainer, state
        torch.cuda.empty_cache()
    return dict(ckpt_dir=ckpt_dir)


# card vs CPU: the bands of tests/test_torch_train_bfmnet.py and
# tests/test_torch_train_pixrefer.py (the port against JAX on the CPU),
# but for PixRefer's updates, 3e-3 of a leaf's max: float32 sum order
# alone moves G's by about 1.3e-3 (the CPU against itself with the batch's
# two rows swapped, read in phase 16 and required inside the band), and
# TF32 convs and matmuls on the card, which the band exists to catch, are
# required outside it
LOSS_REL = 1e-5
BFM_LEAF, BFM_TRUNK, BFM_TRUNK_L2, BFM_NULL = 1e-4, 0.15, 2e-2, 1e-4
GAN_UPDATE, GAN_NULL, GAN_LR = 3e-3, 1e-5, 0.1


def step_offsets(run, ref, zero=GAN_NULL):
    """``run``, ``ref``: (losses, {part: {leaf: SGD update at GAN_LR}}).
    The losses' largest relative difference, and per part the updates'
    largest |difference| over each leaf's max update; a leaf whose
    reference |gradient| is under ``zero`` (float noise on a true gradient
    of zero) is held by the run's largest |gradient| instead, under
    "null"."""
    import numpy as np
    (mc, uc), (mh, uh) = run, ref
    worst = {"loss": max(abs(float(mc[k]) / float(mh[k]) - 1) for k in mh),
             "null": 0.0}
    for part, leaves in uh.items():
        worst[part] = 0.0
        for n, w in leaves.items():
            scale = np.abs(w).max()
            if scale / GAN_LR < zero:
                worst["null"] = max(
                    worst["null"], float(np.abs(uc[part][n]).max()) / GAN_LR)
            else:
                worst[part] = max(worst[part], float(
                    np.abs(uc[part][n] - w).max() / scale))
    return worst


def phase_train_card_vs_cpu(dev, card):
    """16. One BFMNet step and one PixRefer step at the tests' widths
    (tests/_torch_port_cases.py: width-mult 0.25, 64-wide BFMNet; PixRefer
    256², ngf and ndf 8, batch 2, the full VGG trunk) on the card and on
    the CPU from the same weights and batch: the losses and BFMNet's
    gradients against the bands the CPU tests hold the port to JAX with;
    PixRefer's SGD updates (D's, and G's through the updated D) against
    3e-3 of a leaf's max, with the CPU's reading on the batch's rows
    swapped required inside that band and the card's with TF32 on
    required outside it."""
    import numpy as np
    import torch
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.audio.frontend import full_fp32_matmuls
    from voicepuppet_torch.face3d import bfm
    from voicepuppet_torch.train.bfmnet_trainer import BFMNetTrainer
    from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer
    cfg = tcfg.Config(
        bfmnet=tcfg.BFMNetConfig(
            backbone_width_mult=0.25, thinresnet_output_channels=64,
            encode_embedding_size=64, rnn_hidden_size=64,
            training=tcfg.TrainingConfig(drop_rate=0.0)),
        pixrefer=tcfg.PixReferConfig(ngf=8, ndf=8, img_size=256))
    fm = bfm.synthetic_bfm(num_theta=10, num_phi=10, seed=0)
    rng = np.random.RandomState(5)
    batch = (rng.randn(4, 8, 257).astype(np.float32) * 0.1,
             rng.rand(4, 8, 1).astype(np.float32) * 0.1,
             rng.randn(4, 40, 80).astype(np.float32),
             np.array([8, 6, 8, 5], np.int32))
    sgd = lambda params: torch.optim.SGD(params, lr=GAN_LR)
    got = {}
    for d in (dev, "cpu"):
        tr = BFMNetTrainer(cfg, fm, device=d, tx=sgd)
        st = tr.init_state(seed=SEED)
        loss = tr.loss(st, batch)
        loss.backward()
        got[d] = (float(loss.detach()), {n: p.grad.cpu().numpy()
                                for n, p in st.model.named_parameters()})
    (lc, gc), (lh, gh) = got[dev], got["cpu"]
    loss_rel = abs(lc / lh - 1)
    worst = {"head": 0.0, "trunk": 0.0, "null": 0.0}
    dt, wt = [], []
    for n, w in gh.items():
        trunk = n.startswith("mfcc_encoder.MfccNet_0.")
        scale = np.abs(w).max()
        if trunk and scale < BFM_NULL:
            worst["null"] = max(worst["null"], float(np.abs(gc[n]).max()))
            continue
        r = float(np.abs(gc[n] - w).max() / scale)
        worst["trunk" if trunk else "head"] = max(
            worst["trunk" if trunk else "head"], r)
        if trunk:
            dt.append((gc[n] - w).ravel())
            wt.append(w.ravel())
    l2 = float(np.linalg.norm(np.concatenate(dt))
               / np.linalg.norm(np.concatenate(wt)))
    log(f"train card vs cpu: BFMNet step (width 0.25, B 4, T 8, train-mode "
        f"BN) loss rel {loss_rel:.3g} (band {LOSS_REL}); grads / leaf max: "
        f"head {worst['head']:.3g} (band {BFM_LEAF}), conv trunk "
        f"{worst['trunk']:.3g} (band {BFM_TRUNK}), trunk rel L2 {l2:.3g} "
        f"(band {BFM_TRUNK_L2}), zero-gradient BN biases |g| "
        f"{worst['null']:.3g} (band {BFM_NULL}); {card}")
    if not (loss_rel < LOSS_REL and worst["head"] < BFM_LEAF
            and worst["trunk"] < BFM_TRUNK and l2 < BFM_TRUNK_L2
            and worst["null"] < BFM_NULL):
        raise AssertionError("BFMNet card vs CPU outside its bands")

    prng = np.random.RandomState(6)
    pbatch = tuple(prng.rand(2, 256, 256, c).astype(np.float32)
                   for c in (6, 6, 3, 3))
    swapped = tuple(np.ascontiguousarray(a[::-1]) for a in pbatch)

    def gan_step(d, batch, tf32=False):
        """Losses and SGD updates of one D+G step on ``d`` from the seeded
        weights; ``tf32`` turns TF32 on for cuBLAS and cuDNN for it."""
        tr = PixReferTrainer(cfg, device=d, g_tx=sgd, d_tx=sgd)
        st = tr.init_state(seed=SEED)
        before = {k: {n: v.cpu().clone() for n, v in m.state_dict().items()}
                  for k, m in (("gen", st.gen), ("disc", st.disc))}
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            st, m = tr.train_step(st, batch)
        finally:
            full_fp32_matmuls()
        return ({k: float(v) for k, v in m.items()},
                {k: {n: (v.cpu() - before[k][n]).numpy()
                     for n, v in mod.state_dict().items()}
                 for k, mod in (("gen", st.gen), ("disc", st.disc))})

    cpu = gan_step("cpu", pbatch)
    card_run = step_offsets(gan_step(dev, pbatch), cpu)
    rows = step_offsets(gan_step("cpu", swapped), cpu)
    tf32 = step_offsets(gan_step(dev, pbatch, tf32=True), cpu)
    log(f"train card vs cpu: PixRefer SGD step (256², ngf 8, ndf 8, batch "
        f"2, full VGG) losses rel {card_run['loss']:.3g} (band {LOSS_REL}); "
        f"updates / leaf max: D {card_run['disc']:.3g}, G through the "
        f"updated D {card_run['gen']:.3g} (band {GAN_UPDATE}), "
        f"zero-gradient conv biases |g| {card_run['null']:.3g} (band "
        f"{GAN_NULL}); the CPU against itself on the batch's rows swapped: "
        f"D {rows['disc']:.3g}, G {rows['gen']:.3g} (inside the band); the "
        f"card with TF32 on: losses rel {tf32['loss']:.3g}, D "
        f"{tf32['disc']:.3g}, G {tf32['gen']:.3g} (outside it); {card}")
    if not (card_run["loss"] < LOSS_REL and card_run["disc"] < GAN_UPDATE
            and card_run["gen"] < GAN_UPDATE
            and card_run["null"] < GAN_NULL):
        raise AssertionError("PixRefer card vs CPU outside its bands")
    if not (rows["disc"] < GAN_UPDATE and rows["gen"] < GAN_UPDATE):
        raise AssertionError("PixRefer update band: the CPU's own sum-order "
                             "noise falls outside it")
    if not max(tf32["disc"], tf32["gen"]) >= GAN_UPDATE:
        raise AssertionError("PixRefer update band: TF32 on the card falls "
                             "inside it")


def phase_from_checkpoints(cfg, face_model, bfm_dir, px_dir, panel, pcm,
                           identity, counts, reset_counts, n_chunks, card,
                           dev="cuda", chunk=CHUNK):
    """17. The clip served from the checkpoint directories the training
    phases wrote: frames byte-identical to the same state_dicts served
    through Synthesizer directly, K1 once per chunk."""
    import numpy as np
    from voicepuppet_torch.pipeline import synthesize as syn
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    reset_counts()
    t0 = time.perf_counter()
    with syn.SynthesisAssets.from_checkpoints(
            cfg, bfm_dir, px_dir, face_model=face_model, chunk=chunk,
            device=dev) as synth:
        frames = synth.synthesize(panel, pcm, identity)
    wall = time.perf_counter() - t0
    launched = counts()
    if (launched["raster_flat"] != n_chunks
            or raster_launches(launched) != n_chunks):
        raise AssertionError(f"from_checkpoints launches {launched}")
    with syn.Synthesizer(cfg, face_model,
                         CheckpointManager(bfm_dir).load()["model"],
                         CheckpointManager(px_dir).load()["gen"],
                         chunk=chunk, device=dev) as direct:
        want = direct.synthesize(panel, pcm, identity)
    if not (np.array_equal(frames, want) and frames.std(axis=0).max() > 0):
        raise AssertionError("from_checkpoints frames differ from the same "
                             "state_dicts served directly")
    log(f"from_checkpoints: {frames.shape} {frames.dtype} from "
        f"{os.path.basename(bfm_dir)} (step "
        f"{CheckpointManager(bfm_dir).latest_step()}) and "
        f"{os.path.basename(px_dir)} (step "
        f"{CheckpointManager(px_dir).latest_step()}) byte-identical to "
        f"Synthesizer on the same state_dicts, K1 launches "
        f"{launched['raster_flat']} for {n_chunks} chunks, {wall:.2f} s "
        f"with the load; {card}")



# ---- 18-21. the rest of the model zoo -----------------------------------------

PF_STEPS = 5                 # timed PixFlow steps per dtype, after 2 warm
ZOO_STEPS = 8                # timed ATNet / VGNet steps (median)
VG_ALTERNATIVE = 4           # VGNet phase length: steps 0-3 D, 4-7 G
# card vs CPU, updates over a leaf's max update: the CPU tests' JAX-vs-port
# band 1e-3 (tests/test_torch_atvgnet.py, test_torch_pixflow.py) for every
# leaf, ATNet's MfccNet trunk included; the losses and the card's |g| on
# the leaves with a true gradient of zero as phase 16 holds them
# (LOSS_REL, GAN_NULL).  Those leaves are told by the CPU's |g| under
# 1e-4, the CPU tests' rule: their float noise reaches 1.2e-5 on the CPU
# (PixFlow's diffnet.enc_1 bias), the smallest true gradient is 7.7e-4
# (VGNet's D).  The update band is placed per trainer by two readings of
# the same run: the CPU against itself on the batch's rows swapped (float32
# sum order alone) inside it, the card with TF32 convs and matmuls outside
ZOO_UPDATE, ZOO_ZERO = 1e-3, 1e-4

def write_landmark_image_dataset(root, rng, clips, frames, s):
    """VGNet clips: ``<i>.jpg`` frames at ``s``² and 68 landmarks per frame
    on a face-shaped ring, in the 224-pixel frame the stream expects."""
    import numpy as np
    from PIL import Image
    ang = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    ring = np.stack([112 + 70 * np.cos(ang), 112 + 85 * np.sin(ang)], -1)
    lines = []
    for k in range(clips):
        d = os.path.join(root, f"faces{k}")
        os.makedirs(d)
        np.savetxt(os.path.join(d, "landmark.txt"),
                   (ring[None] + rng.randn(frames, 68, 2) * 2).reshape(
                       frames, 136), fmt="%.3f", delimiter=",")
        for i in range(frames):
            Image.fromarray((rng.rand(s, s, 3) * 255).astype(
                np.uint8)).save(os.path.join(d, f"{i}.jpg"))
        lines.append(f"{d}|{frames}")
    path = os.path.join(root, "face_list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def timed_steps(step, batches, warm, n):
    """Run ``step(batch, marks)`` over ``batches`` (``warm`` + ``n``) and
    return the ms of each of the last ``n`` between their first and last
    mark, with each step's split at its middle marks, and their metrics."""
    import torch
    rows = []
    for i, batch in enumerate(batches[:warm + n]):
        marks = []
        m = step(batch, marks)
        if i >= warm:
            rows.append((marks, m))
    torch.cuda.synchronize()
    spans = [[elapsed_ms(a, b) for a, b in zip(mk, mk[1:])] for mk, _ in rows]
    return spans, [{k: float(v) for k, v in m.items()} for _, m in rows]


def phase_pixflow(cfg_main, synth, identity, panel, pcm, dev, counts,
                  reset_counts, card, work):
    """18. PixFlow at Config() (512², ngf 64, ndf 48, batch 3) on 3-panel
    JPEG clips: fit with a checkpoint that restores equal, ms per step in
    float32 and bfloat16 with the D / G split, peak memory; then
    infer_bfm_pixflow on the 55-frame clip (K1 at 512² once per 8 frames),
    K1 at 512², B = 8 against its plain version, and infer_pixflow over
    the panels."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.data.generators import (BackgroundBatches,
                                                   FileSource,
                                                   PixFlowBatcher,
                                                   prefetch_to_device)
    from voicepuppet_torch.pipeline import infer_drivers
    from voicepuppet_torch.pipeline import synthesize as syn
    from voicepuppet_torch.train.checkpoint import CheckpointManager
    from voicepuppet_torch.train.metrics import MetricsLogger
    from voicepuppet_torch.train.pixflow_trainer import (DTYPES,
                                                         PixFlowTrainer)
    os.makedirs(work, exist_ok=True)
    cfg = tcfg.Config()
    p = cfg.pixflow
    s = p.img_size
    lst = write_panel_dataset(work, np.random.RandomState(SEED + 2), 2, 6, s)
    fit_steps = 3                      # global step 6: a checkpoint
    cfg = dataclasses.replace(
        cfg, dataset=dataclasses.replace(cfg.dataset,
                                         train_dataset_path=lst),
        pixflow=dataclasses.replace(p, training=dataclasses.replace(
            p.training, save_interval=2 * fit_steps)))
    src = FileSource(lst, cfg, load_images=True)
    states = {}
    for mode in ("float32", "bfloat16"):
        trainer = PixFlowTrainer(cfg, train_dtype=DTYPES[mode], device=dev)
        state = trainer.init_state(seed=SEED)
        bg = BackgroundBatches(lambda i: iter(PixFlowBatcher(
            cfg, src, seed=i)), num_workers=4)
        batches = prefetch_to_device(bg, dev)
        try:
            if mode == "float32":
                t0 = time.perf_counter()
                ckpt = CheckpointManager(os.path.join(work, "ckpt_pixflow"),
                                         2, cfg.pixflow.training.save_interval)
                logger = MetricsLogger(os.path.join(work, "log_pixflow"),
                                       "pixflow", print_every=0)
                state = trainer.fit(state, batches, fit_steps, logger, ckpt)
                logger.close()
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
                if ckpt.steps() != [2 * fit_steps]:
                    raise AssertionError(f"pixflow checkpoints {ckpt.steps()}")
                restored = ckpt.restore(trainer.init_state(seed=SEED + 1))
                same_state(restored.state_dict(), state.state_dict(),
                           "pixflow restore")
            timed = [next(batches) for _ in range(2 + PF_STEPS)]
        finally:
            bg.close()
        gen = torch.Generator(dev).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        spans, losses = timed_steps(
            lambda b, mk: trainer.train_step(state, b, gen, marks=mk)[1],
            timed, 2, PF_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(np.isfinite(list(r.values())).all() for r in losses):
            raise AssertionError(f"pixflow {mode} losses {losses}")
        total = [a + b for a, b in spans]
        k = total.index(median(total))
        log(f"pixflow train {mode}: {s}² ngf {p.ngf} ndf {p.ndf} batch "
            f"{p.batch_size}, {median(total):.2f} ms/step median over "
            f"{PF_STEPS} steps after 2 warm (two G forwards + D step "
            f"{spans[k][0]:.2f}, G step {spans[k][1]:.2f}; CUDA events); "
            f"peak memory {peak:.2f} GiB; last losses "
            f"{json.dumps({n: round(v, 5) for n, v in losses[-1].items()})}"
            f"{f'; fit {fit_steps} steps + checkpoint {fit_s:.2f} s, restored equal' if mode == 'float32' else ''}"
            f"; {card}")
        states[mode] = (trainer, state)
    trainer, state = states["float32"]
    del states

    n_k1 = -(-FRAMES // VIDEO_CHUNK)
    with tempfile.TemporaryDirectory() as td:
        reset_counts()
        t0 = time.perf_counter()
        frames = infer_drivers.infer_bfm_pixflow(
            cfg_main, synth, trainer, state, identity, panel, pcm,
            out_dir=td, chunk=VIDEO_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        wrote = len(os.listdir(td))
    u8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    if launched["raster_flat"] != n_k1 or raster_launches(launched) != n_k1:
        raise AssertionError(f"infer_bfm_pixflow launches {launched}: K1 "
                             f"once per {VIDEO_CHUNK} frames")
    if (u8.shape != (FRAMES, s, s, 3) or not u8.std(axis=0).max() > 0
            or wrote != FRAMES):
        raise AssertionError(f"infer_bfm_pixflow frames {u8.shape}, wrote "
                             f"{wrote}")
    log(f"pixflow infer_bfm_pixflow: {FRAMES} frames -> {u8.shape} (uint8 "
        f"of the [0,1] output, not constant, {wrote} JPEGs) in {wall:.3f} s "
        f"wall, K1 launches {launched['raster_flat']} (ceil({FRAMES}/"
        f"{VIDEO_CHUNK}) at {s}²); {card}")

    with torch.inference_mode():
        coeff = syn.splice_coeff_sequence(
            identity.bfmcoeff, synth.predict_expressions(pcm))[:VIDEO_CHUNK]
    err = canvas_k1_check(coeff, synth.fm,
                          torch.zeros((VIDEO_CHUNK, 3), device=dev), s,
                          f"{n_k1} launches per infer_bfm_pixflow call", card)

    clip0 = sorted(os.listdir(os.path.join(work, "panels0")),
                   key=lambda n: int(n.split(".")[0]))
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        pf = infer_drivers.infer_pixflow(
            cfg, trainer, state,
            [os.path.join(work, "panels0", n) for n in clip0], td)
        wall_p = time.perf_counter() - t0
    if pf.shape != (len(clip0), s, s, 3) or not np.isfinite(pf).all():
        raise AssertionError(f"infer_pixflow frames {pf.shape}")
    log(f"pixflow infer_pixflow: {len(clip0)} panels -> {pf.shape} in "
        f"{wall_p:.3f} s; {card}")
    del trainer, state
    torch.cuda.empty_cache()
    return dict(launches=launched["raster_flat"], err=err)


def phase_atnet(dev, card, work):
    """19. ATNet at Config() (MfccNet width 1.0, 128-wide, batch 16, T 25,
    dropout 0.25) on on-disk coefficient/landmark/wav clips: fit, ms per
    step, the device's idle share over fit steps with the data pipeline,
    peak memory.  Returns the trainer and state for phase 20."""
    import numpy as np
    import torch
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.data.generators import (ATNetBatcher, FileSource,
                                                   prefetch_to_device)
    from voicepuppet_torch.models.atnet import synthetic_pca_component
    from voicepuppet_torch.train.atnet_trainer import ATNetTrainer
    from voicepuppet_torch.train.bfmnet_trainer import batch_to_device
    os.makedirs(work, exist_ok=True)
    lst = write_bfm_dataset(work, np.random.RandomState(SEED + 3), 4, 240)
    cfg = tcfg.Config()
    a = cfg.atnet
    comp = synthetic_pca_component(a.pca_components, a.landmark_size)
    mean = np.zeros((a.landmark_size,), np.float32)
    trainer = ATNetTrainer(cfg, comp, device=dev)
    state = trainer.init_state(seed=SEED)
    batches = prefetch_to_device(iter(ATNetBatcher(
        cfg, FileSource(lst, cfg), mean, comp.T, device=dev)), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.fit(state, batches, 4, logger=_FetchAll())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    batch = batch_to_device(next(batches), dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    ms = step_ms(lambda: trainer.train_step(state, batch, gen), 3, ZOO_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy = device_busy_share(lambda: trainer.fit(state, batches, 5))
    loss = float(trainer.train_step(state, batch, gen)[1]["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"atnet loss {loss}")
    log(f"atnet train: Config() width 1.0, {a.thinresnet_output_channels}/"
        f"{a.encode_embedding_size}/{a.rnn_hidden_size}, batch "
        f"{a.batch_size}, T 25, dropout {a.training.drop_rate}; fit 4 steps "
        f"with the pipeline in {fit_s:.2f} s (first steps); {ms:.3f} ms/step "
        f"median over {ZOO_STEPS} after 3 warm (CUDA events, one device "
        f"batch); device idle share over 5 fit steps with the data pipeline "
        f"{1 - busy:.3f}; peak memory {peak:.2f} GiB; loss {loss:.4g}; "
        f"{card}")
    return trainer, state, mean, comp


def phase_vgnet(cfg_main, atnet, pcm, dev, card, work):
    """20. VGNet at Config() (128², batch 4, T 15) on on-disk JPEG clips
    with landmarks, ``alternative`` cut to 4 so that a D phase and a G
    phase run: ms per step of each phase, peak memory; then
    infer_atvgnet on the 55-frame clip (ATNet from phase 19)."""
    import tempfile
    import numpy as np
    import torch
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.data.generators import (FileSource, VGNetBatcher,
                                                   prefetch_to_device)
    from voicepuppet_torch.pipeline import infer_drivers
    from voicepuppet_torch.train.vgnet_trainer import VGNetTrainer
    os.makedirs(work, exist_ok=True)
    cfg = tcfg.Config()
    v = cfg.vgnet
    s = v.img_size
    lst = write_landmark_image_dataset(work, np.random.RandomState(SEED + 4),
                                       2, 30, s)
    at_trainer, at_state, mean, comp = atnet
    trainer = VGNetTrainer(cfg, alternative=VG_ALTERNATIVE, device=dev)
    state = trainer.init_state(seed=SEED)
    it = prefetch_to_device(iter(VGNetBatcher(
        cfg, FileSource(lst, cfg, load_images=True), mean, comp.T)), dev)
    batches = [next(it) for _ in range(2)]
    gen = torch.Generator(dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    phase_ms = {}
    for phase in ("D", "G"):
        if trainer.is_d_phase(state.step) != (phase == "D"):
            raise AssertionError(f"vgnet step {state.step} not a {phase} "
                                 "step")
        marks, metrics = [mark()], []
        for i in range(VG_ALTERNATIVE):
            metrics.append(trainer.train_step(state, batches[i % 2],
                                              gen)[1])
            marks.append(mark())
        per = [elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]
        phase_ms[phase] = (median(per[1:]), {k: float(x) for k, x in
                                             metrics[-1].items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(list(m.values())).all()
               for _, m in phase_ms.values()):
        raise AssertionError(f"vgnet losses {phase_ms}")
    log(f"vgnet train: Config() {s}², batch {v.batch_size}, T 15, "
        f"alternative {VG_ALTERNATIVE}: D step {phase_ms['D'][0]:.2f} ms, G "
        f"step {phase_ms['G'][0]:.2f} ms (median of the last "
        f"{VG_ALTERNATIVE - 1} of each phase, CUDA events); peak memory "
        f"{peak:.2f} GiB; losses D {json.dumps(phase_ms['D'][1])} G "
        f"{json.dumps({k: round(x, 4) for k, x in phase_ms['G'][1].items()})}"
        f"; {card}")

    img = np.random.RandomState(SEED + 5).rand(s, s, 3).astype(np.float32)
    ang = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    lmk = np.stack([s / 2 + s * 0.3 * np.cos(ang),
                    s / 2 + s * 0.38 * np.sin(ang)], -1).reshape(136)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        frames = infer_drivers.infer_atvgnet(
            cfg_main, at_trainer, at_state, trainer, state, img, lmk, pcm,
            mean, comp.T, out_dir=td)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if (frames.shape != (FRAMES, s, s, 3) or frames.dtype != np.uint8
            or not frames.std(axis=0).max() > 0):
        raise AssertionError(f"infer_atvgnet frames {frames.shape} "
                             f"{frames.dtype}")
    log(f"atvgnet infer_atvgnet: {FRAMES} frames -> {frames.shape} "
        f"{frames.dtype} (not constant) in {wall:.3f} s; {card}")
    del trainer, state
    torch.cuda.empty_cache()


def phase_zoo_card_vs_cpu(dev, card):
    """21. One SGD step of each new trainer at the CPU tests' widths
    (tests/_torch_port_cases.py: PixFlow ngf/ndf 8 at 64², batch 2; ATNet
    64-wide at width-mult 0.25; VGNet at 32², batch 2, T 4; VGNet's a D
    step and then a G step), on the card and on the CPU from the same
    seeded weights and batch, dropout off on both (masks from a CUDA
    generator cannot equal a CPU one's): losses and updates within the
    bands above, the CPU's reading on the batch's rows swapped inside the
    update band and the card's with TF32 on outside it.  VGNet's D scores
    are printed: its losses have matched the CPU's to the bit."""
    import dataclasses
    import numpy as np
    import torch
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.audio.frontend import full_fp32_matmuls
    from voicepuppet_torch.models import pixflow as pf
    from voicepuppet_torch.models.atnet import synthetic_pca_component
    from voicepuppet_torch.train.atnet_trainer import ATNetTrainer
    from voicepuppet_torch.train.bfmnet_trainer import batch_to_device
    from voicepuppet_torch.train.pixflow_trainer import PixFlowTrainer
    from voicepuppet_torch.train.vgnet_trainer import VGNetTrainer
    sgd = lambda params: torch.optim.SGD(params, lr=GAN_LR)
    cfg = tcfg.Config(
        pixflow=tcfg.PixFlowConfig(ngf=8, ndf=8, img_size=64, batch_size=2),
        atnet=tcfg.ATNetConfig(thinresnet_output_channels=64,
                               encode_embedding_size=64, rnn_hidden_size=64,
                               batch_size=2,
                               training=dataclasses.replace(
                                   tcfg.ATNetConfig().training,
                                   drop_rate=0.0)),
        vgnet=tcfg.VGNetConfig(img_size=32, batch_size=2))
    rng = np.random.RandomState(7)
    b, t = 2, 4
    comp = synthetic_pca_component(6)
    pf_batch = (rng.rand(b, 64, 64, 6).astype(np.float32),
                rng.rand(b, 64, 64, 6).astype(np.float32),
                (rng.rand(b, 64, 64, 3) > 0.5).astype(np.float32))
    at_batch = (rng.randn(b, t, 136).astype(np.float32) * 0.1,
                rng.rand(b, t, 1).astype(np.float32),
                rng.randn(b, t, 3).astype(np.float32) * 0.1,
                rng.randn(b, t * 5, 80).astype(np.float32),
                rng.randn(b, 136).astype(np.float32) * 0.1,
                np.array([t, 3], np.int32))
    vg_batch = (rng.randn(b, t, 136).astype(np.float32) * 0.1,
                rng.rand(b, t, 32, 32, 1).astype(np.float32),
                rng.rand(b, t, 32, 32, 3).astype(np.float32),
                rng.randn(b, 136).astype(np.float32) * 0.1,
                rng.rand(b, 32, 32, 3).astype(np.float32),
                np.array([t, 3], np.int32))
    scores = {}

    def updates(mods, before):
        return {k: {n: (p.detach().cpu() - before[k][n]).numpy()
                    for n, p in m.named_parameters()}
                for k, m in mods.items()}

    def snapshot(mods):
        return {k: {n: p.detach().cpu().clone()
                    for n, p in m.named_parameters()}
                for k, m in mods.items()}

    def pixflow(d, batch):
        tr = PixFlowTrainer(cfg, device=d, g_tx=sgd, d_tx=sgd)
        st = tr.init_state(seed=SEED)
        for m in st.gen.modules():
            if isinstance(m, pf.ResBlock):
                m.drop_rate = 0.0
        mods = {"gen": st.gen, "disc": st.disc}
        before = snapshot(mods)
        return lambda: (tr.train_step(st, batch)[1], updates(mods, before))

    def atnet(d, batch):
        tr = ATNetTrainer(cfg, comp, width_mult=0.25, tx=sgd, device=d)
        st = tr.init_state(seed=SEED)
        mods = {"model": st.model}
        before = snapshot(mods)
        return lambda: (tr.train_step(st, batch)[1], updates(mods, before))

    def vgnet(d, batch):
        tr = VGNetTrainer(cfg, alternative=1, g_tx=sgd, d_tx=sgd, device=d)
        st = tr.init_state(seed=SEED)
        st.disc.dis_rnn.drop_rate = 0.0
        mods = {"gen": st.gen, "disc": st.disc}
        before = snapshot(mods)

        def run():
            lmk, _, img, ex_lmk, ex_img, seq_len = batch_to_device(
                batch, tr.device)
            with torch.no_grad():
                fake = st.gen(ex_img, lmk, ex_lmk, seq_len, train=True)[0]
                scores[d] = [st.disc(x, ex_lmk, seq_len, train=True)[0]
                             .flatten().cpu().numpy() for x in (img, fake)]
            _, m1 = tr.train_step(st, batch)
            _, m2 = tr.train_step(st, batch)
            return {**m1, **m2}, updates(mods, before)
        return run

    def step(build, d, batch, tf32=False):
        """Losses and SGD updates of ``build``'s step on ``d``; ``tf32``
        turns TF32 on for cuBLAS and cuDNN for the step alone (the
        trainer's constructor turns it off)."""
        run = build(d, batch)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return run()
        finally:
            full_fp32_matmuls()

    failed = []
    for name, build, batch in (("pixflow", pixflow, pf_batch),
                               ("atnet", atnet, at_batch),
                               ("vgnet", vgnet, vg_batch)):
        swapped = tuple(np.ascontiguousarray(a[::-1]) for a in batch)
        cpu = step(build, "cpu", batch)
        if name == "vgnet":
            cpu_scores = scores["cpu"]
        got = step_offsets(step(build, dev, batch), cpu, ZOO_ZERO)
        if name == "vgnet":
            card_scores = scores[dev]
        rows = step_offsets(step(build, "cpu", swapped), cpu, ZOO_ZERO)
        tf32 = step_offsets(step(build, dev, batch, tf32=True), cpu,
                            ZOO_ZERO)
        parts = [k for k in got if k not in ("loss", "null")]
        fmt = lambda r: json.dumps({k: float(f"{r[k]:.3g}") for k in parts})
        log(f"zoo card vs cpu: {name} SGD step losses rel {got['loss']:.3g} "
            f"(band {LOSS_REL}); updates / leaf max {fmt(got)} (band "
            f"{ZOO_UPDATE}), zero-gradient leaves |g| {got['null']:.3g} "
            f"(band {GAN_NULL}); the CPU against itself on the batch's rows "
            f"swapped {fmt(rows)} (inside the band); the card with TF32 on: "
            f"losses rel {tf32['loss']:.3g}, updates {fmt(tf32)} (outside "
            f"it); {card}")
        if name == "vgnet":
            real, fake = (np.concatenate([card_scores[i], cpu_scores[i]])
                          for i in (0, 1))
            diff = max(np.abs(card_scores[i] - cpu_scores[i]).max()
                       for i in (0, 1))
            log(f"zoo card vs cpu: vgnet D scores before the steps, card | "
                f"CPU: real {card_scores[0].tolist()} | "
                f"{cpu_scores[0].tolist()}, fake {card_scores[1].tolist()} "
                f"| {cpu_scores[1].tolist()}; max |diff| {diff:.3g}")
            if not (0 < real.min() and real.max() < 1 and 0 < fake.min()
                    and fake.max() < 1):
                failed.append(f"{name} D scores saturated")
        if not (got["loss"] < LOSS_REL and got["null"] < GAN_NULL
                and all(got[k] < ZOO_UPDATE for k in parts)):
            failed.append(f"{name} card vs CPU outside its bands")
        if not all(rows[k] < ZOO_UPDATE for k in parts):
            failed.append(f"{name}: the CPU's own sum-order noise falls "
                          "outside the update band")
        if not max(tf32[k] for k in parts) >= ZOO_UPDATE:
            failed.append(f"{name}: TF32 on the card falls inside the "
                          "update band")
    if failed:
        raise AssertionError(f"zoo card vs CPU: {failed}")

# ---- 22. data parallelism ---------------------------------------------
DP_STEPS = 3
# the CPU tests' bands (tests/test_torch_train_dp*.py): a leaf after the
# batch-norm trunk within 1e-4 of its max |g|; a trunk leaf within 0.15
# and the trunk within 2e-2 in relative L2; a leaf whose true gradient is
# zero (|g| < 1e-4 on the reference) held by |g| < 1e-4
DP_HEAD, DP_TRUNK, DP_TRUNK_L2, DP_NULL = 1e-4, 0.15, 2e-2, 1e-4
# BFMNet's inverted residuals' projection and shortcut BN offsets have a
# true gradient of zero (no activation follows them; every path from them
# runs through 1x1 convs, max pools and sums into a later train-mode BN).
# At full width their float noise reads up to 8.4e-4 on an H100 (single
# step and two ranks; experiments/probe_dp_head.py), over DP_NULL, yet
# 5e-8 of the model's largest |g|: these are held by |g| below DP_NULL_REL
# of it, a band that must stay under every other leaf's max |g|
DP_NULL_REL = 1e-6
DP_TRUNKS = {"bfmnet": "mfcc_encoder.MfccNet_0.", "pixrefer": "gen."}
DP_TRUE_ZERO = {"bfmnet": (r"^mfcc_encoder\.MfccNet_0\.InvertedResidual_"
                           r"\d+\.TFBatchNorm_[23]\.bias$")}
DP_BFM_LENS = (24, 20, 24, 18, 24, 24, 22, 24)


def dp_batch(name):
    """Phase 22's global batch: BFMNet B 8, T 24 (rows of several
    lengths); PixRefer 512², batch 2; numpy from the seed."""
    import numpy as np
    rng = np.random.RandomState(SEED + 22)
    if name == "bfmnet":
        b, t = len(DP_BFM_LENS), max(DP_BFM_LENS)
        return (rng.randn(b, t, 257).astype(np.float32) * 0.1,
                rng.rand(b, t, 1).astype(np.float32) * 0.1,
                rng.randn(b, t * 5, 80).astype(np.float32),
                np.asarray(DP_BFM_LENS, np.int32))
    s = 512
    return tuple(rng.rand(2, s, s, c).astype(np.float32)
                 for c in (6, 6, 3, 3))


def dp_trainer(name, dev, mesh, tx=None, dropout=True):
    """(trainer, {key: module}) of phase 22 at full width: Config()'s
    BFMNet (width 1.0, dropout 0.25 unless ``dropout`` is off: a rank's
    masks cannot be the single process's, the 189² synthetic BFM's loss
    basis) or PixRefer (512², ngf/ndf 64, the VGG trunk from seed 17);
    ``tx`` an optimizer factory (default the reference Adams)."""
    import dataclasses
    from voicepuppet_torch import config as tcfg
    cfg = tcfg.Config()
    if not dropout:
        b = cfg.bfmnet
        cfg = dataclasses.replace(cfg, bfmnet=dataclasses.replace(
            b, training=dataclasses.replace(b.training, drop_rate=0.0)))
    if name == "bfmnet":
        from voicepuppet_torch.face3d import bfm
        from voicepuppet_torch.train.bfmnet_trainer import BFMNetTrainer
        tr = BFMNetTrainer(cfg, bfm.synthetic_bfm(num_theta=189,
                                                  num_phi=189),
                           tx=tx, device=dev, mesh=mesh)
        state = tr.init_state(seed=SEED)
        return tr, state, {"": state.model}
    from voicepuppet_torch.train.pixrefer_trainer import PixReferTrainer
    tr = PixReferTrainer(cfg, g_tx=tx, d_tx=tx, device=dev, mesh=mesh)
    state = tr.init_state(seed=SEED)
    return tr, state, {"gen.": state.gen, "disc.": state.disc}


def dp_step(tr, state, batch, gen):
    if gen is None:
        return tr.train_step(state, batch)
    return tr.train_step(state, batch, gen)


def dp_generator(name, dev, rank=0):
    """BFMNet's dropout stream (the trainers' ``rank_generator``)."""
    from voicepuppet_torch.parallel.mesh import rank_generator
    return rank_generator(SEED, rank, dev) if name == "bfmnet" else None


def dp_grads(modules):
    return {k + n: p.grad.detach().float().cpu()
            for k, m in modules.items() for n, p in m.named_parameters()
            if p.grad is not None}


class frozen_kinks:
    """Within the block every ``F.leaky_relu`` and ``torch.abs`` (the L1
    losses) records the sign of its input (``masks`` None: into
    ``self.masks``, returning what the function returns), or takes that
    sign from ``masks``, each call's in turn: the block of rows of rank
    ``rank`` (a call's leading axis is batch-major, so rank r's rows are
    the r-th block of the recorded run's).  Replayed, the network and loss
    are the recorded run's function piece for piece: an input within float
    noise of a kink keeps the recorded run's slope.  That is the whole of
    BFMNet's two-rank head gap on the card (experiments/probe_dp_head.py):
    one input of the decoder's first leaky ReLU, within float noise of 0,
    took the other slope."""

    def __init__(self, masks=None, rank=0):
        self.replay = masks is not None
        self.masks = list(masks) if self.replay else []
        self.rank = rank

    def _sign(self, x):
        """The recorded sign of ``x``'s rows (int8; 0 where x was 0)."""
        import torch
        if not self.replay:
            s = torch.sign(x).to(torch.int8)
            self.masks.append(s.cpu())
            return s
        i = len(self.used)
        if i >= len(self.masks):
            raise AssertionError("frozen_kinks: more calls than recorded")
        self.used.append(i)
        m = self.masks[i]
        n = x.shape[0]
        if m.shape[1:] != x.shape[1:] or m.shape[0] < (self.rank + 1) * n:
            raise AssertionError(f"frozen_kinks: recorded {tuple(m.shape)}, "
                                 f"replayed on {tuple(x.shape)}")
        return m[self.rank * n:(self.rank + 1) * n].to(x.device)

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        self.saved = (F.leaky_relu, torch.abs)
        self.used = []
        leaky, absolute = self.saved

        def act(x, negative_slope=0.01, inplace=False):
            s = self._sign(x)
            if not self.replay:
                return leaky(x, negative_slope)
            return torch.where(s > 0, x, x * negative_slope)

        def l1(x, *a, **k):
            s = self._sign(x)
            return absolute(x, *a, **k) if not self.replay else s * x
        F.leaky_relu, torch.abs = act, l1
        return self

    def __exit__(self, *exc):
        import torch
        import torch.nn.functional as F
        F.leaky_relu, torch.abs = self.saved
        if self.replay and not exc[0] and len(self.used) != len(self.masks):
            raise AssertionError(f"frozen_kinks: {len(self.used)} calls, "
                                 f"{len(self.masks)} recorded")

    def flips(self, masks):
        """Inputs of this (recording) run on another side of a kink than
        in ``masks``, this rank's rows of them."""
        out = 0
        for a, b in zip(self.masks, masks):
            n = a.shape[0]
            out += int((a != b[self.rank * n:(self.rank + 1) * n]).sum())
        return out


def dp_bands(got, want, name):
    """The readings of gradients ``got`` against ``want``: the worst head
    leaf (over its max |g|) and its name, the head's relative L2, the
    worst trunk leaf and the trunk's relative L2, the largest |g| of a
    leaf whose true gradient is zero, and that leaf's band (DP_NULL, or
    DP_NULL_REL of the largest |g| for the known zeros), and the smallest
    max |g| of the other leaves."""
    import re
    import torch
    trunk = DP_TRUNKS[name]
    zero = re.compile(DP_TRUE_ZERO.get(name, "^$"))
    top = max(float(w.abs().max()) for w in want.values())
    r = {"head": 0.0, "head_name": "", "trunk": 0.0, "null": 0.0,
         "null_band": DP_NULL, "smallest": top}
    diffs = {True: [], False: []}
    refs = {True: [], False: []}
    for k, w in want.items():
        g = got[k]
        scale = float(w.abs().max())
        if scale < DP_NULL or zero.search(k):
            band = DP_NULL_REL * top if zero.search(k) else DP_NULL
            mag = float(g.abs().max())
            if mag / band > r["null"] / r["null_band"]:
                r["null"], r["null_band"] = mag, band
            continue
        r["smallest"] = min(r["smallest"], scale)
        err = float((g - w).abs().max()) / scale
        in_trunk = k.startswith(trunk)
        diffs[in_trunk].append((g - w).reshape(-1))
        refs[in_trunk].append(w.reshape(-1))
        if in_trunk:
            r["trunk"] = max(r["trunk"], err)
        elif err > r["head"]:
            r["head"], r["head_name"] = err, k
    for t, key in ((False, "head_l2"), (True, "trunk_l2")):
        r[key] = (float(torch.cat(diffs[t]).norm()
                        / torch.cat(refs[t]).norm()) if diffs[t] else 0.0)
    return r


def dp_within(r, head=True):
    """Within the CPU tests' bands (the head's too unless ``head`` is
    off)."""
    return ((r["head"] < DP_HEAD or not head) and r["trunk"] < DP_TRUNK
            and r["trunk_l2"] < DP_TRUNK_L2 and r["null"] < r["null_band"]
            < r["smallest"])


def dp_fmt(r):
    return (f"head leaf {r['head']:.3g} ({r['head_name']}), head L2 "
            f"{r['head_l2']:.3g}, trunk leaf {r['trunk']:.3g}, trunk L2 "
            f"{r['trunk_l2']:.3g}, true-zero |g| {r['null']:.3g} (band "
            f"{r['null_band']:.3g}; other leaves' max |g| >= "
            f"{r['smallest']:.3g})")


def digest(modules):
    """SHA-256 of every parameter and buffer of ``modules``, in order."""
    import hashlib
    h = hashlib.sha256()
    for m in modules.values():
        for k, v in m.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_sgd_step(name, dev, mesh, batch, kinks):
    """One SGD step (lr 1, dropout off) of phase 22's ``name`` under
    ``kinks`` (a ``frozen_kinks``): the loss, the gradients after the
    average and (under a mesh) each rank's own before it."""
    import torch
    tr, state, mods = dp_trainer(name, dev, mesh,
                                 lambda p: torch.optim.SGD(p, lr=1.0),
                                 dropout=False)
    names = {id(p): k + n for k, m in mods.items()
             for n, p in m.named_parameters()}
    local = {}
    module = sys.modules[type(tr).__module__]
    real = module.all_reduce_grads_

    def recording(params, group):
        params = [p for p in params if p.grad is not None]
        local.update({names[id(p)]: p.grad.detach().float().cpu().clone()
                      for p in params})
        real(params, group)
    module.all_reduce_grads_ = recording
    try:
        with kinks:
            _, metrics = dp_step(tr, state, batch, dp_generator(name, dev))
    finally:
        module.all_reduce_grads_ = real
    return (float(next(iter(metrics.values()))), dp_grads(mods), local)


def phase22_rank(mesh, name, single_path):
    """One rank of phase 22's two-rank group (gloo, both on the card):
    the SGD step's averaged gradients (dropout off) against the
    single-process global-batch step's (``single_path``), with the leaky
    ReLUs' and L1 terms' kinks frozen to the single step's and as they
    fall; then one
    warm-up and DP_STEPS timed Adam steps (dropout on, each rank its own
    masks) and the digest of the parameters and buffers."""
    import numpy as np
    import torch
    from voicepuppet_torch.parallel.mesh import shard_batch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = mesh.device
    batch = shard_batch(dp_batch(name), mesh)
    want = torch.load(single_path, weights_only=True)
    out = {"want_loss": want["loss"]}
    frozen = frozen_kinks(want["masks"], mesh.rank)
    out["loss"], got, local = dp_sgd_step(name, dev, mesh, batch, frozen)
    out["bands"] = dp_bands(got, want["grads"], name)
    out["twice"] = dp_bands({k: 2 * v for k, v in got.items()},
                            want["grads"], name)
    out["no_average"] = dp_bands(local, want["grads"], name)
    free = frozen_kinks(rank=mesh.rank)
    _, got, _ = dp_sgd_step(name, dev, mesh, batch, free)
    out["free"] = dp_bands(got, want["grads"], name)
    out["flips"] = free.flips(want["masks"])
    tr, state, mods = dp_trainer(name, dev, mesh)
    gen = dp_generator(name, dev, mesh.rank)
    dp_step(tr, state, batch, gen)
    ms = []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp_step(tr, state, batch, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out.update(digest=digest(mods), ms=ms, step=state.step,
               finite=bool(np.isfinite(out["loss"])))
    return out


def phase_dp(dev, card, work):
    """22. Data parallelism at full width, BFMNet (B 8, T 24) and PixRefer
    (512², batch 2): (1) a world-1 NCCL group (``file://`` store): each of
    3 Adam steps bit-equal to the plain step, after a control that the
    plain step repeats itself bit for bit (cuDNN deterministic); (2) two
    spawned ranks sharing the card over gloo: the SGD step's averaged
    gradients, with every leaky ReLU's and L1 term's kink frozen to the
    single-process global-batch step's (``frozen_kinks``), within the CPU
    tests' bands of that step's, and twice the average and a rank's own gradients
    outside them; the same step with the kinks free within them too, or
    its head outside them only where an input crossed a kink; then, after
    a warm-up step, 3 timed Adam steps, after which both ranks' digests
    of parameters and buffers agree; ms per step of each form."""
    import torch
    import torch.distributed as dist
    from voicepuppet_torch.parallel.mesh import make_mesh, shard_batch
    from voicepuppet_torch.parallel.spawn import run_ranks
    work = os.path.abspath(work)
    os.makedirs(work, exist_ok=True)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "nccl_store"), rank=0, world_size=1)
    try:
        mesh = make_mesh(dev)
        if (mesh.world, mesh.group is None) != (1, False):
            raise AssertionError(f"world-1 NCCL group: {mesh}")
        for name in ("bfmnet", "pixrefer"):
            per_step, times = {}, {}
            for label, m in (("plain", None), ("plain again", None),
                             ("world 1", mesh)):
                batch = shard_batch(dp_batch(name), m)
                tr, state, mods = dp_trainer(name, dev, m)
                gen = dp_generator(name, dev)
                sds = []
                for _ in range(DP_STEPS):
                    dp_step(tr, state, batch, gen)
                    sds.append({k + n: v.detach().clone()
                                for k, mod in mods.items()
                                for n, v in mod.state_dict().items()})
                times[label] = step_ms(lambda: dp_step(tr, state, batch,
                                                       gen), 1, 5)
                per_step[label] = sds
                del tr, state, mods
            for label in ("plain again", "world 1"):
                for i, (a, b) in enumerate(zip(per_step["plain"],
                                               per_step[label])):
                    bad = [k for k in a if not torch.equal(a[k], b[k])]
                    if bad:
                        what = ("the plain step does not repeat itself on "
                                "the card" if label == "plain again"
                                else "the world-1 step differs from the "
                                     "plain step")
                        raise AssertionError(f"dp {name}: {what} at step "
                                             f"{i + 1}: {bad[:3]}")
            del per_step
            torch.cuda.empty_cache()
            log(f"dp world-1 nccl {name}: {DP_STEPS} Adam steps bit-equal "
                f"to the plain step (the plain step repeats itself bit for "
                f"bit); ms/step plain {times['plain']:.3f}, again "
                f"{times['plain again']:.3f}, world-1 group "
                f"{times['world 1']:.3f} (median of 5 after 1 warm, CUDA "
                f"events); {card}")
    finally:
        dist.destroy_process_group()
    for name in ("bfmnet", "pixrefer"):
        kinks = frozen_kinks()
        loss, grads, _ = dp_sgd_step(name, dev, None, dp_batch(name), kinks)
        single = os.path.join(work, f"{name}_single.pt")
        torch.save({"grads": grads, "loss": loss, "masks": kinks.masks},
                   single)
        del grads, kinks
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            ranks = run_ranks(phase22_rank, 2, name, single,
                              device=f"cuda:{dev.index or 0}",
                              backend="gloo", timeout=600)
        except RuntimeError as exc:
            log(f"dp 2 ranks {name}: two gloo ranks with CUDA tensors on "
                f"one card failed: {str(exc).splitlines()[-1]}")
            raise
        wall = time.perf_counter() - t0
        r0, r1 = ranks
        if r0["digest"] != r1["digest"] or r0["step"] != r1["step"]:
            raise AssertionError(f"dp {name}: the ranks' parameters and "
                                 f"buffers differ after {DP_STEPS + 1} "
                                 f"steps")
        for key in ("bands", "free"):
            if r0[key] != r1[key]:
                raise AssertionError(f"dp {name}: the ranks' averaged "
                                     f"gradients differ ({key})")
        if not dp_within(r0["bands"]):
            raise AssertionError(f"dp {name}: 2-rank gradients (kinks "
                                 f"frozen) vs the single-process step: "
                                 f"{dp_fmt(r0['bands'])}")
        for key in ("twice", "no_average"):
            if dp_within(r0[key]):
                raise AssertionError(f"dp {name}: {key} passes the bands: "
                                     f"{dp_fmt(r0[key])}")
        flips = r0["flips"] + r1["flips"]
        if not dp_within(r0["free"], head=flips == 0):
            raise AssertionError(f"dp {name}: 2-rank gradients (kinks "
                                 f"free, {flips} crossed) vs the "
                                 f"single-process step: "
                                 f"{dp_fmt(r0['free'])}")
        rel = abs(r0["loss"] - r0["want_loss"]) / abs(r0["want_loss"])
        if not (r0["finite"] and rel < 1e-4):
            raise AssertionError(f"dp {name}: loss {r0['loss']} vs "
                                 f"{r0['want_loss']}")
        log(f"dp 2 ranks gloo {name}: one card; the SGD step's averaged "
            f"gradients vs the single-process global-batch step, leaky "
            f"ReLU and L1 kinks frozen to its: {dp_fmt(r0['bands'])}, in "
            f"the CPU tests' bands {DP_HEAD}/{DP_TRUNK}/{DP_TRUNK_L2}; "
            f"twice the average ({dp_fmt(r0['twice'])}) and rank 0 not averaged "
            f"({dp_fmt(r0['no_average'])}) outside; kinks free: "
            f"{dp_fmt(r0['free'])}, {flips} leaky ReLU or L1 inputs across "
            f"a kink; loss rel {rel:.3g}; ranks bit-identical after "
            f"{DP_STEPS + 1} Adam steps (digest {r0['digest'][:12]}); "
            f"ms/step {', '.join(f'{x:.1f}' for x in r0['ms'])} (host "
            f"clock, steps 2-{DP_STEPS + 1}, after a warm-up step); group "
            f"{wall:.1f} s with the spawn; {card}")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        saved


# ---- 23. the data-prep toolchain -----------------------------------------
PREP_FRAMES = 40
PREP_SRC = 224               # the clip's frames
# the prep nets' outputs card vs CPU (float32, TF32 off), max |diff|: the
# matting net read 6.91e-5 and the segmentation net 8.9e-8 on an H100,
# the matting net with TF32 on 3.55e-4
PREP_MODEL_BAND = 1.5e-4


def save_bfm_mat(model, model_dir):
    """``model`` as the ``BFM_model_front.mat`` that ``load_bfm`` reads."""
    from scipy.io import savemat
    os.makedirs(model_dir, exist_ok=True)
    savemat(os.path.join(model_dir, "BFM_model_front.mat"), {
        "meanshape": model.meanshape, "idBase": model.idBase,
        "exBase": model.exBase, "meantex": model.meantex,
        "texBase": model.texBase, "point_buf": model.point_buf,
        "tri": model.tri, "keypoints": model.keypoints[None] + 1})


def phase_prep(dev, counts, reset_counts, card, work):
    """23. The prep path at full width: ``Schedule`` steps 1, 5 (256²) and
    6 (512² panels, 512x1536, the segmentation and matting nets at a
    seeded random init on the card) over a 40-frame clip (coefficients of
    the 189² synthetic BFM, the landmarks they project to, JPEG frames),
    then ``makelist`` over what step 6 wrote.  K1 exactly ⌈40/16⌉ = 3
    times per render call; the rendered faces bit for bit the plain
    raster's; the nets' outputs card vs CPU within PREP_MODEL_BAND;
    wall seconds of each step."""
    import dataclasses
    import numpy as np
    import torch
    from PIL import Image
    from voicepuppet_torch import config as tcfg
    from voicepuppet_torch.face3d import bfm, morph
    from voicepuppet_torch.tools import makelist
    from voicepuppet_torch.tools import models_torch as mt
    from voicepuppet_torch.tools.prepare_dataset import CHUNK, Schedule
    t = PREP_FRAMES
    model = bfm.synthetic_bfm(num_theta=189, num_phi=189)
    save_bfm_mat(model, os.path.join(work, "models"))
    coeff = bfm.demo_coeff(model, batch=t, seed=SEED + 23)
    rng = np.random.RandomState(SEED + 23)
    coeff[:, 80:144] += rng.randn(t, 64).astype(np.float32) * 0.3
    rec = morph.reconstruct(torch.as_tensor(coeff, device=dev),
                            morph.device_bfm(model, dev))
    lmk = rec.landmarks_2d.reshape(t, -1).cpu().numpy()
    clip = os.path.join(work, "src", "spk0", "clip0")
    os.makedirs(clip)
    for i in range(t):
        Image.fromarray((rng.rand(PREP_SRC, PREP_SRC, 3) * 255).astype(
            np.uint8)).save(os.path.join(clip, f"{i}.jpg"))
    np.savetxt(os.path.join(clip, "landmark.txt"), lmk, fmt="%.3f",
               delimiter=",")
    np.savetxt(os.path.join(clip, "bfmcoeff.txt"), coeff, fmt="%.6f",
               delimiter=",")
    torch.manual_seed(SEED)
    nets = {"seg": (mt.UnetMobilenetV2(),
                    os.path.join(work, "seg.pth")),
            "dim": (mt.DIMMatting(), os.path.join(work, "dim.tar"))}
    for net, path in nets.values():
        torch.save({"state_dict": net.state_dict()}, path)
    cfg = dataclasses.replace(tcfg.Config(),
                              model_dir=os.path.join(work, "models"))
    sched = Schedule(cfg, seg_model_path=nets["seg"][1],
                     matting_model_path=nets["dim"][1], device=dev)
    src = os.path.join(work, "src")
    walls, launches = {}, {}
    for step in (1, 5, 6):
        dst = os.path.join(work, f"step{step}")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sched.run(step, src, dst)
        torch.cuda.synchronize()
        walls[step] = time.perf_counter() - t0
        launched = counts()
        launches[step] = launched["raster_flat"]
        want = 0 if step == 1 else -(-t // CHUNK)
        if n != 1 or launched["raster_flat"] != want \
                or raster_launches(launched) != want:
            raise AssertionError(f"prep step {step}: {n} clips, launches "
                                 f"{launched}, want K1 {want}")
    size6 = cfg.pixrefer.img_size
    for step, size in ((5, 256), (6, size6)):
        out = os.path.join(work, f"step{step}", "spk0", "clip0")
        names = sorted(os.listdir(out))
        with Image.open(os.path.join(out, "0.jpg")) as im:
            shape = (im.height, im.width)
        if len(names) != t or shape != (size, 3 * size):
            raise AssertionError(f"prep step {step}: {len(names)} panels "
                                 f"of {shape}")
    if not os.path.exists(os.path.join(clip, "ear.txt")):
        raise AssertionError("prep step 1 wrote no ear.txt")
    t0 = time.perf_counter()
    lists = (os.path.join(work, "train.txt"), os.path.join(work, "eval.txt"))
    n_train, n_eval = makelist.write_dataset(os.path.join(work, "step6"),
                                             *lists, mode="pixrefer")
    wall_list = time.perf_counter() - t0
    line = open(lists[0]).read().strip()
    if (n_train, n_eval) != (1, 0) or not line.endswith(f"|{t}"):
        raise AssertionError(f"makelist: {n_train}/{n_eval}, {line!r}")
    faces = sched._render_faces(coeff, size6)
    with plain_raster():
        want = sched._render_faces(coeff, size6)
    if not (np.array_equal(faces, want) and faces.max() > 0):
        raise AssertionError("prep faces: K1 differs from the plain raster")
    # the nets on the card against the CPU on one panel's input
    img = np.asarray(Image.open(os.path.join(clip, "0.jpg")).convert(
        "RGB").resize((size6, size6)), np.float32) / 255.0
    seg_cpu = mt.UnetMobilenetV2().eval()
    seg_cpu.load_state(nets["seg"][1])
    prob_card = mt.predict_mask(sched._seg, img)
    prob_cpu = mt.predict_mask(seg_cpu, img)
    dim_cpu = mt.DIMMatting().eval()
    dim_cpu.load_state(nets["dim"][1])
    x = torch.from_numpy(img).permute(2, 0, 1)[None]
    tm = torch.from_numpy((prob_cpu > 0.5).astype(np.float32))[None, None]
    with torch.no_grad():
        a_cpu = dim_cpu(x, tm)
        a_card = sched._dim(x.to(dev), tm.to(dev)).cpu()
        torch.backends.cudnn.allow_tf32 = True
        a_tf32 = sched._dim(x.to(dev), tm.to(dev)).cpu()
        torch.backends.cudnn.allow_tf32 = False
    d_seg = float(np.abs(prob_card - prob_cpu).max())
    d_dim = float((a_card - a_cpu).abs().max())
    d_tf32 = float((a_tf32 - a_cpu).abs().max())
    if not (d_seg < PREP_MODEL_BAND and d_dim < PREP_MODEL_BAND):
        raise AssertionError(f"prep nets card vs CPU: seg {d_seg}, "
                             f"matting {d_dim} (band {PREP_MODEL_BAND})")
    log(f"prep: {t}-frame clip of the {model.num_vertices}-vertex BFM; "
        f"step 1 {walls[1]:.3f} s, step 5 (256²) {walls[5]:.3f} s, step 6 "
        f"({size6}² panels {size6}x{3 * size6}, seg + matting nets on the "
        f"card) {walls[6]:.3f} s, makelist {wall_list:.4f} s; K1 launches "
        f"{launches[5]} and {launches[6]} per render call "
        f"(ceil({t}/{CHUNK})); faces at {size6}² == plain raster bit for "
        f"bit; nets card vs CPU max |diff| seg {d_seg:.3g}, matting "
        f"{d_dim:.3g} (band {PREP_MODEL_BAND}; matting with TF32 on "
        f"{d_tf32:.3g}); {card}")
    return dict(launches=launches[5] + launches[6])



# ---- 24. sharded serving ----------------------------------------------------
# float32 G + rgb8, sharded against one process: the JAX package's own
# bound (tests/test_pipeline.py:195, 320): +-1 code, under 5% of values
SHARD_MAX_CODES = 1
SHARD_SHARE = 0.05
# the serving default (bf16 G, yuv420), mean |diff| in codes against one
# process: two gloo ranks on an H100 read 0.0949 (frames) and 0.0976
# (spatial), the controls 0.1998 (a chunk of 16 in place of 32) and 0.1961
# (each rank's BN moments over its own rows); the band lies between
SHARD_SERVED_MEAN_CODES = 0.15
SHARD_PARTITIONS = ("frames", "spatial")


class k1_capture:
    """Within the block, ``synthesize.render_colors_auto`` records each
    call's frame count and keeps the first call's inputs and image."""

    def __enter__(self):
        from voicepuppet_torch.pipeline import synthesize as syn
        self._saved = real = syn.render_colors_auto
        self.frames, self.first = [], None

        def wrapped(verts, colors, tri, **kw):
            out = real(verts, colors, tri, **kw)
            self.frames.append(int(verts.shape[0]))
            if self.first is None:
                self.first = (verts.clone(), colors.clone(), tri, kw,
                              out[0].clone())
            return out
        syn.render_colors_auto = wrapped
        return self

    def __exit__(self, *exc):
        from voicepuppet_torch.pipeline import synthesize as syn
        syn.render_colors_auto = self._saved

    def equals_plain(self) -> bool:
        """The first call's image bit for bit the plain raster's."""
        import torch
        from voicepuppet_torch.face3d import raster as plain
        verts, colors, tri, kw, img = self.first
        want, _ = plain.render_colors(verts, colors, tri, kw["h"], kw["w"])
        return bool(torch.equal(img, want))


def shard_synth(cfg, grid, chunk, trees, mesh, partition, served,
                device="cuda"):
    """Phase 24's Synthesizer over ``mesh`` (None: one process on
    ``device``): ``cfg``, the ``grid``² synthetic BFM, ``trees``;
    ``served`` the serving default (bf16 G, yuv420), else float32 G and
    rgb8."""
    import torch
    from voicepuppet_torch.face3d import bfm
    from voicepuppet_torch.pipeline import synthesize as syn
    kw = {} if served else dict(gan_dtype=torch.float32,
                                transfer_format="rgb8")
    return syn.Synthesizer(cfg, bfm.synthetic_bfm(num_theta=grid,
                                                  num_phi=grid),
                           *trees, chunk=chunk, mesh=mesh,
                           mesh_partition=partition, device=device, **kw)


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def render_ms(synth, ident, panel, pcm, mesh=None, repeats=2):
    """Wall ms of each of ``repeats`` ``render_frames`` calls of the
    clip's frames (on a mesh, every rank starting after a barrier)."""
    import numpy as np
    from voicepuppet_torch.pipeline import synthesize as syn
    s = synth.img_size
    coeff = syn.splice_coeff_sequence(ident.bfmcoeff,
                                      synth.predict_expressions(pcm))
    bg = np.zeros((1, s, s, 3), np.float32)
    ms = []
    for _ in range(repeats):
        if mesh is not None:
            mesh.barrier()
        t0 = time.perf_counter()
        synth.render_frames(coeff, ident, panel[:, s:2 * s], panel[:, :s],
                            bg)
        _sync(synth.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def phase24_rank(mesh, cfg, grid, chunk, panel, pcm):
    """One rank of phase 24's two gloo ranks on the card: in each
    partition, the clip served at float32 + rgb8 and at the serving
    default, K1's launches and frame counts per call and its first image
    against the plain raster, wall ms of two more ``render_frames`` calls;
    the frames partition again with each rank's BN moments over its own
    rows (the control); a spatial stream's first block.  Every launch
    count is set to 0 just before each of these calls and K1's read just
    after.  Rank 0 returns the frames."""
    import contextlib
    import numpy as np
    import torch
    from voicepuppet_torch.ops import KERNELS
    from voicepuppet_torch.pipeline import streaming
    from voicepuppet_torch.pipeline import synthesize as syn
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = mesh.device
    k1 = next(k for k in KERNELS if k.name == "raster_flat")
    trees = syn.SynthesisAssets.init_trees(cfg, SEED)
    s = cfg.pixrefer.img_size
    out = {"launches": 0}

    def counted(fn, *args):
        """``fn(*args)`` -> (its result, K1's launches in it)."""
        for k in KERNELS:
            k.launches = 0
        got = fn(*args)
        _sync(dev)
        out["launches"] += k1.launches
        return got, k1.launches

    def per_rank_bn(synth, ident):
        saved = syn.sync_bn
        syn.sync_bn = lambda group, *m: contextlib.nullcontext()
        try:
            return synth.synthesize(panel, pcm, ident)
        finally:
            syn.sync_bn = saved

    def stream(synth, ident):
        ss = streaming.StreamingSynthesizer(synth, ident, panel[:, s:2 * s],
                                            panel[:, :s])
        # the clip's frames: one frame of silence more
        pcm_s = np.concatenate([pcm, np.zeros(cfg.frame_wav_scale,
                                              np.float32)])
        mesh.barrier()
        t0 = time.perf_counter()
        first, blocks = None, []
        for i in range(0, pcm_s.shape[0], STREAM_PIECE):
            blocks += ss.feed(pcm_s[i:i + STREAM_PIECE])
            if first is None and ss.coeffs._next_frame > 0:
                first = (time.perf_counter() - t0) * 1e3
        blocks += ss.flush()
        if first is None:
            first = (time.perf_counter() - t0) * 1e3
        return {"first_ms": first, "blocks": len(blocks),
                "frames": sum(b.shape[0] for b in blocks)}

    for partition in SHARD_PARTITIONS:
        for served in (False, True):
            synth = shard_synth(cfg, grid, chunk, trees, mesh, partition,
                                served)
            ident = syn.synthetic_identity(synth.face_model, SEED, s)
            key = f"{partition} {'served' if served else 'f32'}"
            with k1_capture() as cap:
                frames, n = counted(synth.synthesize, panel, pcm, ident)
            out[key] = {"frames": frames, "k1": n,
                        "k1_frames": cap.frames,
                        "k1_plain": cap.equals_plain(),
                        "chunk": synth.chunk}
            if served:
                out[key]["ms"], out[key]["k1_timed"] = counted(
                    render_ms, synth, ident, panel, pcm, mesh)
            if served and partition == "frames":
                out["frames per-rank BN"], _ = counted(per_rank_bn, synth,
                                                       ident)
            if served and partition == "spatial":
                out["stream"], out["stream_k1"] = counted(stream, synth,
                                                          ident)
            synth.close()
            del synth
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def phase_sharded(cfg, grid, trees, panel, pcm, identity, dev, counts,
                  reset_counts, card, work):
    """24. Sharded serving at full width (Config(), ngf 64 at 512², the
    189² BFM, the 55-frame clip, chunk 32): (1) a world-1 NCCL group
    (``file://`` store) in both partitions serves frames byte-identical to
    the plain Synthesizer's (cuDNN deterministic), K1 once per chunk; (2)
    two spawned gloo ranks sharing the card, each partition: at float32 +
    rgb8 rank 0's frames within +-1 code, under 5% of values differing,
    of one process's; at the serving default the mean |diff| within
    SHARD_SERVED_MEAN_CODES, which a chunk of 16 and per-rank BN moments
    must exceed; (3) K1 on each rank ceil(55/32) = 2 times per call, on
    16 frames (frames) or 32 (spatial), its first image bit for bit the
    plain raster's; (4) wall ms per render_frames call of the world-1
    group in each partition beside the plain Synthesizer's (timed before
    and after them), and of the two gloo ranks on one card, with the
    first block of a spatial stream.  Returns K1's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from voicepuppet_torch.parallel.mesh import make_mesh
    from voicepuppet_torch.parallel.spawn import run_ranks
    work = os.path.abspath(work)
    os.makedirs(work, exist_ok=True)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    n_chunks = -(-FRAMES // CHUNK)
    setup = (cfg, grid, CHUNK, trees)
    launches = 0
    try:
        plain = shard_synth(*setup, None, "frames", True, dev)
        want = plain.synthesize(panel, pcm, identity)
        plain_ms = render_ms(plain, identity, panel, pcm)
        plain32 = shard_synth(*setup, None, "frames", False, dev)
        want32 = plain32.synthesize(panel, pcm, identity)
        c16 = shard_synth(cfg, grid, CHUNK // 2, trees, None, "frames",
                          True, dev)
        control16 = c16.synthesize(panel, pcm, identity)
        for sy in (plain32, c16):
            sy.close()
        del plain32, c16
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            work, "nccl_store"), rank=0, world_size=1)
        try:
            mesh = make_mesh(dev)
            if (mesh.world, mesh.group is None) != (1, False):
                raise AssertionError(f"world-1 NCCL group: {mesh}")
            world1_ms = {}
            for partition in SHARD_PARTITIONS:
                synth = shard_synth(*setup, mesh, partition, True)
                reset_counts()
                got = synth.synthesize(panel, pcm, identity)
                _sync(dev)
                launched = counts()
                launches += launched["raster_flat"]
                if (launched["raster_flat"] != n_chunks
                        or not np.array_equal(got, want)):
                    raise AssertionError(
                        f"sharded world-1 {partition}: K1 {launched}, "
                        f"frames equal {np.array_equal(got, want)}")
                reset_counts()
                world1_ms[partition] = render_ms(synth, identity, panel,
                                                 pcm, mesh)
                launches += counts()["raster_flat"]
                synth.close()
            # the plain synth again, after the world-1 calls: its spread
            reset_counts()
            plain_ms += render_ms(plain, identity, panel, pcm)
            launches += counts()["raster_flat"]
            plain.close()
            del plain
            log(f"sharded world-1 nccl: frames and spatial partitions serve "
                f"the 55 frames byte-identical to the plain Synthesizer "
                f"(cuDNN deterministic), K1 {n_chunks} launches each; wall "
                f"ms per render_frames call: plain "
                f"{', '.join(f'{x:.1f}' for x in plain_ms)}; "
                + "; ".join(f"{p} {', '.join(f'{x:.1f}' for x in v)}"
                            for p, v in world1_ms.items())
                + f"; {card}")
        finally:
            dist.destroy_process_group()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_ranks(phase24_rank, 2, cfg, grid, CHUNK, panel, pcm,
                          device=(f"cuda:{dev.index or 0}"
                                  if dev.type == "cuda" else "cpu"),
                          backend="gloo", timeout=600)
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    r0, r1 = ranks
    launches += r0["launches"] + r1["launches"]
    c_mean = frame_diff(control16, want)[0]
    for partition in SHARD_PARTITIONS:
        f32, served = (r0[f"{partition} {v}"] for v in ("f32", "served"))
        rows = CHUNK // 2 if partition == "frames" else CHUNK
        for r in ranks:
            for v in ("f32", "served"):
                got = r[f"{partition} {v}"]
                if (got["k1"] != n_chunks or not got["k1_plain"]
                        or got["k1_frames"][0] != rows
                        or got["chunk"] != CHUNK
                        or got.get("k1_timed", 2 * n_chunks)
                        != 2 * n_chunks):
                    raise AssertionError(
                        f"sharded {partition} {v} rank: K1 {got['k1']} "
                        f"launches on {got['k1_frames']} frames, equal to "
                        f"the plain raster {got['k1_plain']}, chunk "
                        f"{got['chunk']}")
        if r1[f"{partition} served"]["frames"] is not None:
            raise AssertionError("rank 1 returned frames")
        d = np.abs(f32["frames"].astype(np.int16) - want32.astype(np.int16))
        dmax, share = int(d.max()), float((d > 0).mean())
        s_mean, s_over1, s_max = frame_diff(served["frames"], want)
        controls = {f"chunk {CHUNK // 2}": c_mean}
        if partition == "frames":
            controls["per-rank BN"] = frame_diff(r0["frames per-rank BN"],
                                                 want)[0]
        log(f"sharded 2 ranks gloo {partition}: float32 + rgb8 vs one "
            f"process max {dmax} codes, {share:.4g} of values differing "
            f"(bound {SHARD_MAX_CODES}, {SHARD_SHARE}); served bf16 + "
            f"yuv420 mean |diff| {s_mean:.4g} codes, share > 1 code "
            f"{s_over1:.4g}, max {s_max} (band {SHARD_SERVED_MEAN_CODES}); "
            f"controls {json.dumps({k: round(v, 4) for k, v in controls.items()})}; "
            f"K1 {n_chunks} launches per call on each rank, "
            f"{rows} frames each, bit-equal to the plain raster; wall ms "
            f"per render_frames call {', '.join(f'{x:.1f}' for x in served['ms'])} "
            f"(two gloo ranks on one card: a correctness run's times, not "
            f"a multi-card rate); {card}")
        if not (dmax <= SHARD_MAX_CODES and share < SHARD_SHARE):
            raise AssertionError(f"sharded {partition} float32 frames off "
                                 f"one process's: max {dmax}, share {share}")
        if not s_mean < SHARD_SERVED_MEAN_CODES:
            raise AssertionError(f"sharded {partition} served frames off "
                                 f"one process's by {s_mean}")
        bad = [k for k, v in controls.items()
               if not v >= SHARD_SERVED_MEAN_CODES]
        if bad:
            raise AssertionError(f"the served band misses the controls "
                                 f"{bad}: {controls}")
    st = r0["stream"]
    if (st["frames"] != FRAMES or r1["stream"]["frames"] != 0
            or r0["stream_k1"] != st["blocks"]
            or r1["stream_k1"] != st["blocks"]):
        raise AssertionError(f"spatial stream: rank 0 {st['frames']} frames,"
                             f" rank 1 {r1['stream']['frames']}, K1 "
                             f"{r0['stream_k1']}, {r1['stream_k1']} "
                             f"launches for {st['blocks']} blocks")
    log(f"sharded spatial stream: {st['blocks']} blocks, {st['frames']} "
        f"frames on rank 0, none on rank 1; first feed to first block "
        f"{st['first_ms']:.1f} ms (two gloo ranks on one card); group "
        f"{wall:.1f} s with the spawn; {card}")
    return {"launches": launches}


# ---- 25. the serving and training experiments -------------------------------
EXPERIMENTS = (
    ("profile_serving", ["--chunks", "16", "8", "--blocks", "2", "--k", "2",
                         "--rounds", "1"]),
    ("profile_tail_bucket", ["--pairs", "1"]),
    ("profile_decode", ["--k", "2", "--rounds", "1"]),
    ("profile_frame_tail", ["--k", "2", "--rounds", "2"]),
    ("profile_pack", ["--k", "2", "--rounds", "1"]),
    ("profile_pack_inprogram", ["--k", "2", "--rounds", "1"]),
    ("streaming_quality", []),
    ("profile_training", ["--k", "2", "--rounds", "1"]),
    ("profile_pixrefer_step", ["--k", "2", "--rounds", "1"]),
    ("profile_pixrefer_vgg", ["--k", "2", "--rounds", "1"]),
    ("profile_pixrefer_layers", ["--k", "2", "--rounds", "1"]),
    ("profile_pixrefer_levers", ["--k", "2", "--rounds", "1"]),
    ("gen_bf16_inputs", []),
)


def phase_experiments(dev, counts, reset_counts, card):
    """25. Each serving and training experiment's ``main`` once on the card
    at full scale and reduced rounds (K = 2, one round): its exactness
    checks hold inside it and its final table is printed; an entry point
    that raises fails the phase.  K1's launches per entry point; the
    frame-program ones must launch it.  Returns K1's launches and each
    entry point's result."""
    import importlib
    import torch
    results, launches = {}, {}
    for name, argv in EXPERIMENTS:
        mod = importlib.import_module(f"voicepuppet_torch.experiments.{name}")
        reset_counts()
        t0 = time.perf_counter()
        results[name] = mod.main(["--device", str(dev)] + argv)
        torch.cuda.synchronize()
        launches[name] = counts()["raster_flat"]
        torch.cuda.empty_cache()
        log(f"experiment {name}: {time.perf_counter() - t0:.1f} s, K1 "
            f"{launches[name]} launches; {card}")
    silent = [n for n in ("profile_serving", "profile_tail_bucket",
                          "profile_frame_tail", "profile_pack_inprogram",
                          "gen_bf16_inputs")
              if launches[n] == 0]
    if silent:
        raise AssertionError(f"K1 did not launch in {silent}")
    return {"launches": sum(launches.values()), "results": results}


# ---- 26. the port's benchmark and graft entry points ------------------------
BENCH_BUDGET_S = 30.0       # the bench's timed runs (360 s by default)
BENCH_MIN_RUNS = 4
# entry() (float32 G) against Synthesizer.frame_program_for at float32,
# mean |diff| of the uint8 frames in codes (equal on the CPU,
# tests/test_torch_graft_entry.py)
ENTRY_MEAN_CODES = 0.01


def raster_launches(launched):
    """The raster kernels' launches in a ``counts()`` reading (the batch
    norm's are counted beside them, under ``batchnorm``)."""
    return sum(n for name, n in launched.items() if name != "batchnorm")


def phase_bn(dev, card):
    """The generators' batch norm kernels (``ops/batchnorm.py``,
    ``csrc/norm.cu``): its build; on every BN shape of both served
    generators, bf16 and float32, each moment mode, channels_last, the
    moments within 1e-5 of float64 and bit-equal to ``moments_plain``, the
    output byte-equal to the plain version and to eager ``normalize`` of
    its own moments; the whole generators no further from float32 than
    eager, the counters of a forward and of a training step; the kernels'
    ms against the bound, the plain version's, eager's and the library's
    one call (``library_ms``) on the prediction's shapes.  Returns the
    times of the largest (PixFlow's decoder_2) and the largest |Δ| from
    the plain version over every case (``max_abs_err``)."""
    import torch
    from voicepuppet_torch.ops import batchnorm as bn
    from voicepuppet_torch.ops import batchnorm_selftest as bst
    t0 = time.perf_counter()
    bn.LIBRARY.function()
    log(f"bn build: csrc/norm.cu in {time.perf_counter() - t0:.2f} s")
    for line in bn.LIBRARY.build_log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"  ptxas: {line.strip()}")
    worst, err, eager_err, cases = 0.0, 0.0, 0.0, 0
    for _, shape, own in bst.served_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            for per_frame in (own, not own):
                r = bst.check_shape(shape, dtype, per_frame, dev)
                worst = max(worst, r["moment_rel"])
                err = max(err, r["max_abs_err"])
                eager_err = max(eager_err, r["eager_abs_err"])
                cases += 1
    log(f"bn shapes: {cases} cases (every BN shape of both generators, "
        f"bf16 and float32, both moment modes, channels_last): moments "
        f"within {worst:.3e} of float64 (band {bst.MOMENT_REL}), bit-equal "
        f"to moments_plain; outputs byte-equal to the plain version (max "
        f"|Δ| {err}) and to eager normalize of the kernels' moments, and run "
        f"to run; max |Δ| from the eager module with its own moments "
        f"{eager_err}")
    for name, r in bst.check_generators(dev).items():
        log(f"bn generator {name}: mean |Δ| from float32 G: kernels "
            f"{r['kernel_vs_float32']:.5g}, eager {r['eager_vs_float32']:.5g} "
            f"(band {bst.GEN_DRIFT}x), library one-call "
            f"{r['library_vs_float32']:.5g}; from eager: kernels "
            f"{r['kernel_vs_eager']:.5g}, eager with its moments' sums "
            f"reordered {r['reordered_vs_eager']:.5g}; G forward "
            f"{r['kernel_g_ms']:.3f} ms with the kernels, "
            f"{r['library_g_ms']:.3f} ms with the library's batch norm; "
            f"vp.bn.fused {r['fused']} of {r['bn_elements']} BN elements, "
            f"vp.bn.eager {r['eager']}; {card}")
    r = bst.training_step_counts(dev)
    log(f"bn training step: vp.bn.fused {r['fused']}, vp.bn.eager "
        f"{r['eager']}")
    timed = []
    for label, shape, per_frame in (
            ("pixflow decoder_2", (32, 128, 256, 256), True),
            ("pixrefer merged2_decoder_2", (32, 64, 256, 256), False),
            ("pixrefer merged_encoder_5", (32, 512, 2, 2), False)):
        r = bst.time_shape(shape, torch.bfloat16, per_frame, dev)
        timed.append(r)
        pl = bn.plan(shape, per_frame, 2, True)
        log(f"bn time {label} {list(shape)} bf16 per_frame={per_frame} "
            f"channels_last: kernel {r['kernel_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, kernel/bound {r['ratio']:.3f}, plain "
            f"{r['plain_ms']:.4f}, eager {r['eager_ms']:.4f}, library_ms "
            f"(one call) {r['library_ms']:.4f}; {pl}; {card}")
    torch.cuda.synchronize()
    return dict(timed[0], max_abs_err=err)


def phase_bench(cfg, trees, dev, counts, reset_counts, card):
    """26. (a) ``voicepuppet_torch.bench.measure`` on the card with the
    full workload (Config(), the 189² BFM, 8 s of audio: 201 frames, 7
    chunks of 32) and a 30 s budget: the selftest's verdict "ok", at
    least 4 runs, every frames/s finite, and K1 launched exactly 7 times
    per call (the warm-up and each run) plus the frame-rate probe's 36
    frame programs plus the selftest's own launches (read alone first);
    the bench's JSON line, the median and spread of its runs.  (b)
    ``graft_entry.entry()``: its frame step launches K1 once, and its
    frames (float32 G, as the JAX entry's), as uint8, agree within
    ENTRY_MEAN_CODES with ``Synthesizer.frame_program_for(graft_entry.
    entry_identity())`` at ``gan_dtype=float32`` and ``rgb8`` on the same
    arguments and weights; the served bf16 program's distance on them is
    printed beside it, not gated: GEN_BF16_MEAN_CODES holds the main
    path's inputs (phase 8), and the bf16 distance grows on zero
    references and at 4 frames (experiment ``gen_bf16_inputs``, phase
    25).  (c) ``graft_entry.dryrun_multichip(2)`` as two gloo ranks
    sharing the card.  Returns K1's launches on the main path (the
    selftest's comparisons left out)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from voicepuppet_torch import bench, graft_entry
    from voicepuppet_torch.face3d import bfm
    from voicepuppet_torch.ops import raster_selftest
    from voicepuppet_torch.pipeline import synthesize as syn

    # (a) the bench
    reset_counts()
    raster_selftest.run_selftest(dev)
    torch.cuda.synchronize()
    selftest_k1 = counts()["raster_flat"]
    face_model = bfm.synthetic_bfm(num_theta=bench.MESH_GRID,
                                   num_phi=bench.MESH_GRID, seed=0)
    saved_env = {k: os.environ.pop(k, None) for k in (
        "BENCH_CHUNK", "BENCH_RASTER_GROUP", "BENCH_RASTER_PARITY")}
    try:
        reset_counts()
        t0 = time.perf_counter()
        rec = bench.measure(cfg, face_model, device=dev,
                            budget_s=BENCH_BUDGET_S, min_runs=BENCH_MIN_RUNS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
    finally:
        for k, v in saved_env.items():
            if v is not None:
                os.environ[k] = v
    n_frames = rec["frames"].shape[0]
    chunks = -(-n_frames // CHUNK)
    probe = (1 + 8) * (1 + 3)     # estimate_chunk_compute(k=8, repeats=3)
    want_k1 = chunks * (rec["runs"] + 1) + probe + selftest_k1
    fps = rec["fps_runs"]
    line = io.StringIO()
    bench._best.update(rec)
    with contextlib.redirect_stdout(line):
        bench._emit(rec["fps"])
    log(f"bench line: {line.getvalue().strip()}")
    log(f"bench: {rec['runs']} runs of {n_frames} frames in {wall:.1f} s, "
        f"frames/s best {max(fps):.2f}, median {median(fps):.2f}, "
        f"min {min(fps):.2f}; compute_fps {rec['compute_fps']}; d2h MB/s "
        f"{json.dumps([round(v, 1) for v in rec['d2h_MBps']])}; K1 "
        f"{launched['raster_flat']} launches ({chunks} x {rec['runs'] + 1} "
        f"calls + {probe} probe frame programs + {selftest_k1} selftest); "
        f"{card}")
    if rec["raster_parity"] != "ok":
        raise AssertionError(f"bench raster_parity {rec['raster_parity']}")
    if not (rec["runs"] >= BENCH_MIN_RUNS and np.isfinite(fps).all()
            and len(fps) == rec["runs"] and n_frames == 201):
        raise AssertionError(f"bench runs {rec['runs']}, frames "
                             f"{n_frames}, fps {fps}")
    if rec["compute_fps"] is not None and not np.isfinite(
            rec["compute_fps"]):
        raise AssertionError(f"bench compute_fps {rec['compute_fps']}")
    if launched["raster_flat"] != want_k1:
        raise AssertionError(f"bench K1 launches {launched['raster_flat']},"
                             f" not {want_k1}")
    main_k1 = launched["raster_flat"] - selftest_k1

    # (b) the graft entry's frame step
    frame_step, args = graft_entry.entry(dev, cfg)
    reset_counts()
    out = frame_step(*args)
    torch.cuda.synchronize()
    launched = counts()
    if launched["raster_flat"] != 1 or raster_launches(launched) != 1:
        raise AssertionError(f"entry launches {launched}: K1 once")
    main_k1 += 1
    gen, coeff, angles, background, face3d_ref, fg_ref = args
    entry_face = bfm.synthetic_bfm(num_theta=graft_entry.ENTRY_GRID,
                                   num_phi=graft_entry.ENTRY_GRID, seed=0)
    s = cfg.pixrefer.img_size
    c = coeff.shape[0]
    got = torch.clamp(out * 255.0, 0, 255).to(torch.uint8)
    identity = graft_entry.entry_identity(cfg)
    idx = torch.arange(c, device=dev)
    diffs = {}
    for label, dtype in (("float32", torch.float32),
                         ("served bf16", torch.bfloat16)):
        synth = syn.Synthesizer(cfg, entry_face, trees[0], gen.state_dict(),
                                chunk=c, gan_dtype=dtype,
                                transfer_format="rgb8", device=dev)
        with torch.inference_mode():
            want = synth.frame_program_for(identity)(
                coeff, angles, background, idx, face3d_ref, fg_ref)
        d = (got.int() - want.int()).abs()
        diffs[label] = (float(d.float().mean()), int(d.max()))
        synth.close()
    log(f"graft entry: frame step {tuple(out.shape)} {out.dtype}, K1 1 "
        f"launch; uint8 |diff| against Synthesizer.frame_program_for at "
        f"float32 mean {diffs['float32'][0]:.4g} max {diffs['float32'][1]} "
        f"codes (band: mean < {ENTRY_MEAN_CODES}); the served bf16 program "
        f"mean {diffs['served bf16'][0]:.4g} max {diffs['served bf16'][1]} "
        f"(not gated on these inputs); {card}")
    if not (torch.isfinite(out).all() and out.shape == (c, s, s, 3)):
        raise AssertionError("entry frames not finite or mis-shaped")
    if not diffs["float32"][0] < ENTRY_MEAN_CODES:
        raise AssertionError(f"entry frames off the frame program: {diffs}")
    del gen, args, frame_step
    torch.cuda.empty_cache()

    # (c) the multi-rank dryrun, two gloo ranks sharing the card
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(2, device=dev)
    log(f"graft dryrun_multichip(2): two gloo ranks on one card, "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": main_k1, "fps_runs": fps}


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
    from voicepuppet_torch.ops import batchnorm
    from voicepuppet_torch.ops import batchnorm_selftest as bst
    from voicepuppet_torch.ops import raster_probes as probes
    from voicepuppet_torch.ops import raster_selftest
    from voicepuppet_torch.ops.raster import LIBRARY
    from voicepuppet_torch.experiments import _common as probe_common
    from voicepuppet_torch.experiments import (profile_raster,
                                               profile_raster2,
                                               profile_raster3,
                                               profile_raster_grouped,
                                               profile_raster_regacc)
    from voicepuppet_torch.pipeline import drain_native, streaming
    from voicepuppet_torch.pipeline import synthesize as syn
    from voicepuppet_torch.pipeline.align import head_sway_angles

    every_kernel = KERNELS + probes.PROBE_KERNELS

    def reset_counts():
        for k in every_kernel:
            k.launches = 0
        batchnorm.LIBRARY.launches = 0

    def counts():
        got = {k.name: k.launches for k in every_kernel}
        got["batchnorm"] = batchnorm.LIBRARY.launches
        return got

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

    # ---- 2b. the generators' batch norm kernels -------------------------
    t0 = time.perf_counter()
    bn_run = phase_bn(dev, card)
    log(f"phase 2b (bn kernels) {time.perf_counter() - t0:.1f} s")

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
        got_img, got_mask = render_colors_auto(
            verts, colors, tri, h=224, w=224, bb=synth.program.raster_bb)
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
    bn_modules = sum(isinstance(m, px.StatelessBatchNorm)
                     for m in synth.gen.modules())
    reset_counts()
    t0 = time.perf_counter()
    served = []
    bn_calls = len(bst._bn_inputs(synth.gen, lambda: served.append(
        synth.synthesize(panel, pcm, identity))))
    frames = served[0]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = counts()
    launches = launched["raster_flat"]
    if launches != n_chunks or raster_launches(launched) != launches:
        raise AssertionError(f"main path launches {launched} for "
                             f"{n_chunks} chunks: K1 once per chunk and "
                             "no other raster kernel")
    bn_launches = launched["batchnorm"]
    if not bn_launches == bn_calls == n_chunks * bn_modules:
        raise AssertionError(f"main path batch norm launches {bn_launches}"
                             f", BN calls {bn_calls}: every call of G's "
                             f"{bn_modules} BN modules in each of {n_chunks}"
                             " chunks on the kernels")
    if frames.shape != (FRAMES, s, s, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.dtype} {frames.shape}")
    if not frames.std(axis=0).max() > 0 or frames.max() == 0:
        raise AssertionError("frames are constant")
    log(f"main path: synthesize -> {frames.shape} {frames.dtype}, raster "
        f"launches {launches} for {n_chunks} chunks, batch norm launches "
        f"{bn_launches} ({bn_modules} a G forward), first call "
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
    unpack_ms, unpacked = {}, {}
    for name, unpack in (("numpy", syn._unpack_yuv420),
                         ("native", drain_native.unpack_yuv420)):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            unpacked[name] = unpack(packed, s)
            best = min(best, time.perf_counter() - t0)
        unpack_ms[name] = best * 1e3
    # the host picks the native routine's SSSE3 body or its plain loop
    # from its own CPU: the served bytes are checked here, on that host
    np.testing.assert_array_equal(unpacked["native"], unpacked["numpy"])
    log(f"host: YUV 4:2:0 unpack {unpack_ms['numpy']:.1f} ms numpy (the "
        f"oracle), {unpack_ms['native']:.2f} ms native (the drain's, "
        f"byte-equal) per chunk of {CHUNK} (best of 3)")
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
            or raster_launches(stream_launched) != k4_launches):
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
                or raster_launches(tex_launched) != 2):
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
    log(f"raster B={CHUNK} ratios in this run: K4/K1 {k4_ms / k_ms:.3f} "
        f"(group 4, image and mask), K5/K3 {k5_ms / k3_ms:.3f} (group 4, "
        f"winner and depth); {card}")

    # X2 at unroll 1, fb 1 is K1's schedule in the probe's kernel: its time
    # beside K1's; then each call split into its device launches
    def x2_k1_schedule():
        return probes.raster_u(verts, tri, 224, 224, fb=1, unroll=1)

    def k1_winner():
        return tops.rasterize_winner(verts, tri, 224, 224)

    with torch.inference_mode():
        for a, b, part in zip(x2_k1_schedule(), k1_winner(),
                              ("winner", "depth")):
            raster_selftest.expect_equal(a, b, f"X2 (1,1) == K1 {part}")
        k1w_ms = cuda_ms(k1_winner, 50, 5)
        x211_ms = cuda_ms(x2_k1_schedule, 50, 5)
        splits = {
            "K1 render_colors_auto": lambda: render_colors_auto(
                verts, colors, tri, h=224, w=224),
            "K1 rasterize_winner": k1_winner,
            "K3 rasterize_winner_interp": lambda: tops.rasterize_winner_interp(
                verts, tri, 224, 224),
            "X2 (1,1) raster_u(unroll=1, fb=1)": x2_k1_schedule,
        }
        for label, fn in splits.items():
            split = device_split(fn)
            log(f"split B={CHUNK}, {label}: "
                + (json.dumps({k: {"launches": n, "mean_us": us}
                               for k, (n, us) in split.items()})
                   if split else "the profiler recorded no device event")
                + f" (5 calls, torch.profiler); {card}")
    log(f"raster B={CHUNK} winner + depth: K1 {k1w_ms:.4f} ms, X2 (1,1) "
        f"(unroll_walk_kernel<1,1>, K1's schedule) {x211_ms:.4f} ms, bit "
        f"for bit equal; X2 (1,1) / K1 {x211_ms / k1w_ms:.3f}; {card}")
    # the walk steps of these inputs (ops/raster_selftest.py's CPU model)
    x0, y0, bw, bh = raster_selftest.walk_entries(verts.cpu().numpy(),
                                                  tri.cpu().numpy(), 224, 224)
    area = raster_selftest.warp_areas(bw, bh)
    old_steps, new_steps = int(area.max(1).sum()), int(
        (-(-area.sum(1) // 32)).sum())
    log(f"raster B={CHUNK} walk steps (CPU model): one-thread walk "
        f"{old_steps} (lanes busy {area.sum() / (32 * old_steps):.3f}), "
        f"balanced walk {new_steps} ({old_steps / new_steps:.3f}x fewer), "
        f"{area.sum()} bbox px over {area.shape[0]} warps")

    # ---- 7. the probe path: X1-X3 and the A/B profile entry points ------
    t0 = time.perf_counter()
    probe_report = raster_selftest.run_probe_selftest(dev)
    torch.cuda.synchronize()
    log(f"probe parity: {len(probe_report)} cases bit-exact probe == plain "
        f"(X1 both modes, X2 at fb x unroll {probes.UNROLLS}, X3 at "
        f"{raster_selftest.REGACC_SETTINGS + raster_selftest.REGACC_LISTS};"
        f" X1 == K1 off degenerate "
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
        rk1 = plain.rasterize_winner(rv, rtri, 224, 224)
        # the 192² mesh: F = 72,962 is no multiple of 32, so X1's warps
        # straddle frames there
        rx1_want = plain.rasterize_winner_inside_only(rv, rtri, 224, 224)
        rx1 = probes.raster_b(rv, rtri, 224, 224)
        rx1_depth = probes.raster_b(rv, rtri, 224, 224, winner=False)
        torch.cuda.synchronize()
        for got, want, part in ((rx1[0], rx1_want[0], "winner"),
                                (rx1[1], rx1_want[1], "depth"),
                                (rx1_depth, rx1_want[1], "depth-only")):
            raster_selftest.expect_equal(got, want,
                                         f"192² probe mesh X1 {part}")
        rx1_deg = raster_selftest.expect_inside_only_matches_k1(
            rx1[0], rk1[0], rv, rtri, "192² probe mesh")
        x2_err = 0.0
        x2_settings = ((1, 1),) + profile_raster3.SETTINGS   # (fb, unroll)
        for fb, unroll in x2_settings:
            x2 = probes.raster_u(pv, ptri, 224, 224, fb=fb, unroll=unroll)
            torch.cuda.synchronize()
            raster_selftest.expect_equal(x2[0], pk1[0],
                                         f"X2 fb {fb} unroll {unroll} winner")
            raster_selftest.expect_equal(x2[1], pk1[1],
                                         f"X2 fb {fb} unroll {unroll} depth")
            x2_err = max(x2_err, float((x2[1] - pk1[1]).abs().max()))
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
        f"{x2_settings}; {rtri.shape[0]} triangles (warps straddle "
        f"frames): X1 == plain in both modes, == K1 off degenerate winners "
        f"({rx1_deg} px); X3 == "
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
            for fb, u in x2_settings}
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
    # each X1, X2 and X3 launch as the card builds it, X1's walk steps
    # against K1's and X3's union rectangles against whole bands
    # (ops/raster_selftest.py's CPU model)
    pv_np, ptri_np = pv.cpu().numpy(), ptri.cpu().numpy()
    k1_box = raster_selftest.walk_entries(pv_np, ptri_np, 224, 224)
    x1_box = raster_selftest.inside_only_entries(pv_np, ptri_np, 224, 224)
    walk_steps = [int((-(-raster_selftest.warp_areas(bw, bh).sum(1) // 32))
                      .sum()) for bw, bh in (k1_box[2:], x1_box[2:])]
    # and each call split into its device launches (memset, walk, resolve)
    with torch.inference_mode():
        splits = {"K1": device_split(
            lambda: tops.rasterize_winner(pv, ptri, 224, 224))}
        for winner, mode, ms in ((1, "winner", x1_ms),
                                 (0, "depth-only", x1d_ms)):
            splits[mode] = device_split(
                lambda winner=winner: probes.raster_b(pv, ptri, 224, 224,
                                                      winner=bool(winner)))
            shape = probes.PROBE_INSIDE_ONLY.launch_shape(winner, 0, 224,
                                                          224)
            log(f"probe launch X1 {mode} (inside_only_walk_kernel<"
                f"{'false' if winner else 'true'}>): {json.dumps(shape)}, "
                f"{ms:.4f} ms, {ms / pk1_ms:.3f}x K1; walk steps (CPU "
                f"model) {walk_steps[1]} against K1's {walk_steps[0]}; "
                f"{card}")
    for label, split in splits.items():
        log(f"split B={PROBE_BATCH} probe mesh, {label}: "
            + (json.dumps({k: {"launches": n, "mean_us": us}
                           for k, (n, us) in split.items()})
               if split else "the profiler recorded no device event")
            + f" (5 calls, torch.profiler); {card}")
    for fb, unroll in x2_settings:
        shape = probes.PROBE_UNROLL.launch_shape(unroll, fb, 224, 224)
        ms = x2_ms[f"U{unroll}_fb{fb}"]
        log(f"probe launch X2 U{unroll}_fb{fb} (unroll_walk_kernel): "
            f"{json.dumps(shape)}, {ms:.4f} ms, {ms / pk1_ms:.3f}x K1; "
            f"{card}")
    rv_np, rtri_np = rv.cpu().numpy(), rtri.cpu().numpy()
    for win, fb in raster_selftest.REGACC_SETTINGS:
        chunk = 512 // fb
        shape = probes.PROBE_BAND_REGACC.launch_shape(win, chunk, 224, 224)
        ms = x3_ms[f"win{win}_fb{fb}"]
        union = raster_selftest.band_boxes(rv_np, rtri_np, 224, 224, win,
                                           chunk)[5]
        drawn = union[:, 0] <= union[:, 1]
        keys = int(((union[drawn, 1] - union[drawn, 0] + 1)
                    * (union[drawn, 3] - union[drawn, 2] + 1)).sum())
        band_keys = union.shape[0] * win * 224
        log(f"probe launch X3 win{win}_fb{fb} (band_walk_kernel, chunk "
            f"{chunk}): {json.dumps(shape)}, {ms:.4f} ms, "
            f"{ms / rk1_ms:.3f}x K1; union rectangles (CPU model): "
            f"{int(drawn.sum())} of {union.shape[0]} blocks draw, {keys} "
            f"keys zeroed and flushed against {band_keys} for whole bands "
            f"({keys / band_keys:.4f}); {card}")

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

    # ---- 9-13. the reference's weight files, the R-Net, the leftovers, --
    # the 672² mesh video ------------------------------------------------
    phase_tf_oracle(dev)
    phase_released_weights(cfg, face_model, trees, panel, pcm, identity,
                           frames, counts, reset_counts, n_chunks, card)
    phase_rnet(cfg, synth, panel, pcm, dev, counts, reset_counts, n_chunks,
               card)
    phase_leftovers(cfg, face_model, trees, synth, identity, panel, pcm, dev,
                    breakdown["frame_program_total"], card)
    phase_mesh_video(cfg, synth, identity, pcm, dev, counts, reset_counts,
                     card)

    # ---- 14-17. training, and serving what it wrote ----------------------
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        bfm_run = phase_train_bfmnet(dev, counts, reset_counts, card,
                                     os.path.join(work, "bfmnet"))
        px_run = phase_train_pixrefer(dev, card, os.path.join(work, "px"))
        phase_train_card_vs_cpu(dev, card)
        phase_from_checkpoints(cfg, face_model, bfm_run["ckpt_dir"],
                               px_run["ckpt_dir"], panel, pcm, identity,
                               counts, reset_counts, n_chunks, card)

    # ---- 18-21. PixFlow, ATNet, VGNet -------------------------------------
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        pf_run = phase_pixflow(cfg, synth, identity, panel, pcm, dev, counts,
                               reset_counts, card,
                               os.path.join(work, "pixflow"))
        log(f"phase 18 (pixflow) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        atnet = phase_atnet(dev, card, os.path.join(work, "atnet"))
        log(f"phase 19 (atnet) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_vgnet(cfg, atnet, pcm, dev, card, os.path.join(work, "vgnet"))
        log(f"phase 20 (vgnet, atvgnet) {time.perf_counter() - t0:.1f} s")
        del atnet
        t0 = time.perf_counter()
        phase_zoo_card_vs_cpu(dev, card)
        log(f"phase 21 (zoo card vs cpu) {time.perf_counter() - t0:.1f} s")

    # ---- 22-23. data parallelism, the prep toolchain ----------------------
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        phase_dp(dev, card, os.path.join(work, "dp"))
        log(f"phase 22 (data parallel) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        prep_run = phase_prep(dev, counts, reset_counts, card,
                              os.path.join(work, "prep"))
        log(f"phase 23 (prep) {time.perf_counter() - t0:.1f} s")

    # ---- 24-25. sharded serving, the serving and training experiments ------
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        shard_run = phase_sharded(cfg, 189, trees, panel, pcm,
                                  identity, dev, counts, reset_counts, card,
                                  os.path.join(work, "shard"))
        log(f"phase 24 (sharded serving) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    exp_run = phase_experiments(dev, counts, reset_counts, card)
    log(f"phase 25 (experiments) {time.perf_counter() - t0:.1f} s")

    # ---- 26. the benchmark and the graft entry points ----------------------
    t0 = time.perf_counter()
    bench_run = phase_bench(cfg, trees, dev, counts, reset_counts, card)
    log(f"phase 26 (bench, graft entry) {time.perf_counter() - t0:.1f} s")

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
        ("raster_flat", f"{pallas}:126",
         launches + bfm_run["grid_launches"] + pf_run["launches"]
         + prep_run["launches"] + shard_run["launches"]
         + exp_run["launches"] + bench_run["launches"],
         max(max_abs_err, pf_run["err"]), k_ms, p_ms, bound, bound_by),
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
    kernels.append({
        "name": "batchnorm", "route": "cuda",
        "source": "voicepuppet_torch/csrc/norm.cu", "replaces": None,
        "launches": bn_launches, "max_abs_err": bn_run["max_abs_err"],
        "ms": bn_run["kernel_ms"], "plain_ms": bn_run["plain_ms"],
        "bound_ms": bn_run["bound_ms"], "bound_by": "bytes",
        "library_ms": bn_run["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
