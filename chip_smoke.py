#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (voicepuppet_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (found on PATH, under $CUDA_HOME or
/usr/local/cuda).  Phases, each of which fails the script on any fault:

  1. device and build   print the card's name and power limit; build the
                        raster kernel (csrc/raster.cu) into build/.
  2. raster parity      the CUDA kernel against its plain PyTorch version,
                        bit for bit, through every entry point: the quirk
                        meshes of ops/raster_selftest.py, then the full
                        189² synthetic mesh at 224² for one 32-frame chunk of
                        the main path, through render_colors_auto.
  3. main path          SynthesisAssets.demo(Config(), synthetic_bfm(189,
                        189), chunk=32) and Synthesizer.synthesize on 2.2 s of
                        audio (55 frames: one chunk of 32 and a tail bucket
                        of 32), the generator in bfloat16 at ngf 64, 512².
                        The raster launch count must equal the chunk count.
                        Then frames/s over timed repeats, a per-stage time
                        breakdown of one chunk, and the kernel's time beside
                        the plain version's and its bound.
  4. reference checks   the card against the port on the CPU (float32
                        everywhere): the full-width expression coefficients,
                        and whole frames at a small size (ngf 8, 256²); the
                        served bf16 generator against its float32 weights on
                        the card at full width, with a bf16-BN-moments
                        control that the band must reject.

Output: progress lines, one JSON line of kernels, the nvidia-smi line, and
as the last line {"ok": true, "device": {...}}.  Exits nonzero, printing
no result, when there is no CUDA device or no voicepuppet_torch beside it.
"""

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
    from voicepuppet_torch.ops import RASTER, render_colors_auto
    from voicepuppet_torch.ops import raster_selftest
    from voicepuppet_torch.pipeline import synthesize as syn
    from voicepuppet_torch.pipeline.align import head_sway_angles

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    RASTER.library()
    log(f"build: raster kernel in {time.perf_counter() - t0:.2f} s")
    for line in RASTER.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 2. raster parity on the quirk meshes ---------------------------
    t0 = time.perf_counter()
    report = raster_selftest.run_selftest(dev)
    torch.cuda.synchronize()
    log(f"parity: {len(report)} quirk cases bit-exact kernel == plain "
        f"({time.perf_counter() - t0:.2f} s): {json.dumps(report)}")

    # ---- 3. the main path at full width ---------------------------------
    cfg = tcfg.Config()
    face_model = bfm.synthetic_bfm(num_theta=189, num_phi=189)
    synth, identity = syn.SynthesisAssets.demo(cfg, seed=SEED,
                                               face_model=face_model,
                                               chunk=CHUNK)
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
    log(f"parity: full mesh B={CHUNK} 224² bit-exact through "
        f"render_colors_auto, {covered / CHUNK:.0f} covered px/frame")

    n_chunks = -(-FRAMES // CHUNK)
    RASTER.launches = 0
    t0 = time.perf_counter()
    frames = synth.synthesize(panel, pcm, identity)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = RASTER.launches
    if launches != n_chunks:
        raise AssertionError(f"raster kernel launched {launches} times for "
                             f"{n_chunks} chunks")
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

    # ---- 4. the card against the port on the CPU ------------------------
    cpu_bfm, cpu_g = syn.SynthesisAssets.init_trees(cfg, SEED)
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

    kernels = [{
        "name": "raster_flat",
        "route": "cuda",
        "source": "voicepuppet_torch/csrc/raster.cu",
        "replaces": "voicepuppet_tpu/ops/raster_pallas.py:126",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
