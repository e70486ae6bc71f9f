"""In-program A/B of the YUV pack forms: the pack swapped inside the whole
frame program, timed through ``Synthesizer.estimate_chunk_compute``.

Port of experiments/profile_pack_inprogram.py: the served chained pack
(``synthesize._pack_yuv420``) against the einsum form
(``profile_pack.pack_matmul``) at chunk 16 on the 189² mesh.  The frame
program looks the module attribute up at every call, so it is swapped
around every call and restored in ``finally``.  Warm-up of each form,
then ``--rounds`` interleaved rounds, the minimum of each.

    python -m voicepuppet_torch.experiments.profile_pack_inprogram [--rounds 3]
"""

import sys

import voicepuppet_torch.pipeline.synthesize as syn
from voicepuppet_torch.experiments import _common
from voicepuppet_torch.experiments.profile_pack import pack_matmul


def main(argv=None):
    p = _common.experiment_parser(__doc__)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--k", type=int, default=8)
    args = p.parse_args(argv)
    cfg = _common.config_for(args.scale)
    s, ident = syn.SynthesisAssets.demo(
        cfg, face_model=_common.face_model_for(args.scale, seed=0),
        chunk=args.chunk, device=args.device)
    production_pack = syn._pack_yuv420
    packs = {"chained": production_pack, "einsum": pack_matmul}
    best = {n: float("inf") for n in packs}
    try:
        for name, pack in packs.items():
            syn._pack_yuv420 = pack
            per = s.estimate_chunk_compute(ident, k=args.k, repeats=1)
            print(f"warm {name}: {per * 1e3:.3f} ms/chunk", flush=True)
        for r in range(args.rounds):
            for name, pack in packs.items():
                syn._pack_yuv420 = pack
                per = s.estimate_chunk_compute(ident, k=args.k, repeats=2)
                best[name] = min(best[name], per)
                print(f"round {r} {name:8s}: {per * 1e3:9.3f} ms/chunk",
                      flush=True)
    finally:
        syn._pack_yuv420 = production_pack
        s.close()
    print(f"\nFINAL per-variant minima ({args.chunk}-frame chunk, whole "
          f"frame program) on {_common.device_line(args.device)}:")
    for n, v in sorted(best.items(), key=lambda kv: kv[1]):
        print(f"  {n:8s}: {v * 1e3:9.3f} ms")
    print(f"  einsum - chained: {(best['einsum'] - best['chained']) * 1e3:+.3f}"
          f" ms", flush=True)
    return {n: v * 1e3 for n, v in best.items()}


if __name__ == "__main__":
    main(sys.argv[1:])
