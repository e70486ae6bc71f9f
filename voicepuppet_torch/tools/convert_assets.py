"""One-command, TF-free conversion of the reference's released assets
(port of ``voicepuppet_tpu/tools/convert_assets.py``).

The reference ships an ``allmodels/`` directory of proprietary/pretrained
binaries (reference README.md:32-35) that its code loads with TensorFlow
at runtime (infer_bfmvid.py:46-50, 207-218; train_pixrefer.py:80-92;
utils/bfm_load_data.py:9-21, 45-114).  This CLI sweeps such a directory
once, converts/validates every recognized asset with the certified
pure-NumPy readers (tools/tf_bundle.py, tools/tf_checkpoint.py,
tools/bfm_tools.py), and writes a self-contained model dir plus a
``manifest.json`` describing exactly what was found, produced, or absent::

    python -m voicepuppet_torch.tools.convert_assets \
        --assets_dir allmodels --out_dir converted [--config params.yml]

  asset found in --assets_dir          ->  output in --out_dir
  ----------------------------------------------------------------------
  01_MorphableModel.mat + Exp_Pca.bin  ->  BFM_model_front.mat
    (+ BFM_front_idx/BFM_exp_idx/facemodel_info .mat; bfm_tools.convert_bfm09)
  BFM_model_front.mat                  ->  copied + validated (bfm.load_bfm)
  similarity_Lm3D_all.mat              ->  lm3d.npy  ([5,3]; pipeline.align)
  ckpt_bfmnet/bfmnet-<step>            ->  bfmnet.npz        (TF-named;
                                            tf_checkpoint.load_bfmnet_npz)
  ckpt_pixrefer/pixrefernet-<step>     ->  pixrefer_g.npz / pixrefer_d.npz
  vgg_16.ckpt                          ->  vgg16_weights.npz (the filename
                                            the PixRefer trainer auto-loads
                                            from cfg.model_dir)
  FaceReconModel.pb                    ->  rnet.npz (slim-named; the
                                            --rnet_npz input of synthesize)
  mobilenetV2_model_checkpoint_metric.pth / BEST_checkpoint.tar
                                       ->  validated in place against the
                                            torch prep models (torch reads
                                            them natively; models_torch)

Checkpoint conversion builds the port's modules from ``--config`` (the
reference's params.yml schema), loads through ``tools/tf_checkpoint.py``'s
loaders and fails loudly when any mapped variable is absent or
mis-shaped — a renamed or resized release cannot silently produce a
scrambled model.  Absent assets are recorded as ``missing`` in the
manifest (exit code 0); a present-but-unparseable asset is ``failed``
(exit code 1).  The files and ``manifest.json`` are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

# output filenames (out_dir becomes a drop-in model dir)
BFM_MAT = "BFM_model_front.mat"
LM3D_NPY = "lm3d.npy"
BFMNET_NPZ = "bfmnet.npz"
PIXREFER_G_NPZ = "pixrefer_g.npz"
PIXREFER_D_NPZ = "pixrefer_d.npz"
VGG_NPZ = "vgg16_weights.npz"   # train/pixrefer_trainer.py auto-load name
RNET_NPZ = "rnet.npz"


def find_checkpoint_prefix(root: str, stem: str) -> Optional[str]:
    """Locate a TF checkpoint for ``stem`` anywhere under ``root``.

    Recognizes both formats the certified reader handles: a V2
    TensorBundle (``<stem>-<step>.index`` + data shards — the layout of
    the released ``ckpt_bfmnet/bfmnet-65000``) and a V1 single file
    (``<stem>-<step>`` with no extension).  Multiple steps -> highest
    step wins (the reference's released dirs keep one, but a training dir
    may hold several)."""
    pat = re.compile(re.escape(stem) + r"-(\d+)$")
    best: Tuple[int, Optional[str]] = (-1, None)
    for path in glob.iglob(os.path.join(glob.escape(root), "**", f"{stem}-*"),
                           recursive=True):
        base = os.path.basename(path)
        name = base[:-len(".index")] if base.endswith(".index") else base
        m = pat.match(name)  # data shards never match (suffix after step)
        if not m or not os.path.isfile(path):
            continue
        step = int(m.group(1))
        if step > best[0]:
            best = (step, os.path.join(os.path.dirname(path), name))
    return best[1]


def find_file(root: str, name: str) -> Optional[str]:
    """First file named ``name`` under ``root`` (depth-first, stable)."""
    direct = os.path.join(root, name)
    if os.path.isfile(direct):
        return direct
    hits = sorted(glob.iglob(os.path.join(glob.escape(root), "**", name),
                             recursive=True))
    return hits[0] if hits else None


def convert_bfmnet(prefix: str, out_path: str, cfg) -> Dict:
    """Released BFMNet ckpt -> TF-named npz, through the port's BFMNet of
    ``cfg`` so every shape is checked against the configured model
    (infer_bfmvid.py:207-213 restores the same variables into the
    inference graph)."""
    from voicepuppet_torch.models.bfmnet import BFMNet
    from voicepuppet_torch.tools import tf_checkpoint as tfc

    state, loaded, missing = tfc.load_bfmnet_ckpt(prefix,
                                                  BFMNet(cfg.bfmnet))
    if missing:
        raise ValueError(
            f"{len(missing)} BFMNet variables absent or mis-shaped in "
            f"{prefix}, e.g. {missing[:3]} — wrong config widths?")
    tfc.export_bfmnet_npz(state, out_path)
    return {"loaded": len(loaded)}


def convert_pixrefer(prefix: str, g_path: str, d_path: str, cfg) -> Dict:
    """Released PixRefer ckpt -> generator npz (strict) + discriminator
    npz (best-effort: inference only needs G; an inference-only export
    without D is recorded, not fatal)."""
    from voicepuppet_torch.models import pixrefer as px
    from voicepuppet_torch.tools import tf_checkpoint as tfc

    (g_state, g_loaded, g_missing), dres = tfc.load_pixrefer_ckpt(
        prefix, px.PixReferNet(cfg.pixrefer),
        px.Discriminator(cfg.pixrefer.ndf))
    if g_missing:
        raise ValueError(
            f"{len(g_missing)} PixRefer generator variables absent or "
            f"mis-shaped in {prefix}, e.g. {g_missing[:3]}")
    tfc.export_npz(g_state, tfc.pixrefer_generator_name_map(), g_path)
    info: Dict = {"g_loaded": len(g_loaded)}
    d_state, d_loaded, d_missing = dres
    if d_missing:
        info["d_skipped"] = (f"{len(d_missing)} discriminator variables "
                             f"missing, e.g. {d_missing[:3]}")
    else:
        tfc.export_npz(d_state, tfc.pixrefer_discriminator_name_map(),
                       d_path)
        info["d_loaded"] = len(d_loaded)
    return info


def convert_vgg(ckpt_path: str, out_path: str) -> Dict:
    """vgg_16.ckpt -> the flat conv{i}_{j}_{kernel,bias} npz (slim's HWIO
    kernels as stored) that models.vgg.load_weights and the PixRefer
    trainer consume (train_pixrefer.py:80-92; exclude list
    vgg_simple.py:160).  A variable that is neither mapped nor excluded
    raises, as an absent trunk variable does."""
    from voicepuppet_torch.tools import tf_bundle as tb

    arrays = tb.read_checkpoint(ckpt_path)
    mapped = dict(tb.vgg16_slim_name_map())
    missing = [k for k in mapped if k not in arrays]
    if missing:
        raise ValueError(
            f"checkpoint lacks {len(missing)} vgg_16 trunk variables, "
            f"e.g. {missing[:3]}")
    out: Dict[str, np.ndarray] = {}
    for name, arr in arrays.items():
        if name in mapped:
            layer, part = mapped[name].split(".")
            key = f"{layer}_{'kernel' if part == 'weight' else 'bias'}"
            out[key] = np.asarray(arr, np.float32)
        elif not any(name.startswith(p)
                     for p in tb.VGG16_EXCLUDE_PREFIXES):
            raise ValueError(
                f"unexpected variable {name!r} in vgg_16 checkpoint "
                f"(not in the conv1-4 map or the exclude list)")
    np.savez(out_path, **out)
    return {"loaded": len(out)}


def convert_rnet(pb_path: str, out_path: str) -> Dict:
    """FaceReconModel.pb -> slim-named npz for pipeline.rnet.load_rnet_npz,
    validated against the port's full RNet (every mapped variable must be
    present and correctly shaped; infer_bfmvid.py:46-50)."""
    from voicepuppet_torch.pipeline.rnet import (RNet, load_rnet_arrays,
                                                 read_rnet_graphdef)

    arrays = read_rnet_graphdef(pb_path)
    if not arrays:
        raise ValueError(f"{pb_path}: no resnet_v1_50 Const nodes found — "
                         "not a frozen FaceReconModel graph?")
    _, loaded, missing = load_rnet_arrays(arrays, RNet())
    if missing:
        raise ValueError(
            f"{len(missing)} R-Net variables absent or mis-shaped in "
            f"{pb_path}, e.g. {missing[:3]}")
    np.savez(out_path,
             **{k.replace("/", "|"): v for k, v in arrays.items()})
    return {"loaded": len(loaded)}


def convert_bfm(assets_dir: str, out_dir: str) -> Dict:
    """BFM09 research assets -> validated BFM_model_front.mat in out_dir.

    Uses a pre-built BFM_model_front.mat when the release ships one;
    otherwise runs the front-crop conversion (bfm_load_data.py:45-114)
    from the raw 01_MorphableModel.mat + Exp_Pca.bin."""
    from voicepuppet_torch.face3d.bfm import load_bfm
    from voicepuppet_torch.tools.bfm_tools import convert_bfm09

    prebuilt = find_file(assets_dir, BFM_MAT)
    out_path = os.path.join(out_dir, BFM_MAT)
    if prebuilt is not None:
        if os.path.abspath(prebuilt) != os.path.abspath(out_path):
            shutil.copyfile(prebuilt, out_path)
        action = "copied"
    else:
        convert_bfm09(os.path.dirname(find_file(assets_dir,
                                                "01_MorphableModel.mat")),
                      out_dir=out_dir)
        action = "converted"
    model = load_bfm(out_dir)   # fail-loud layout validation
    return {"action": action, "num_vertices": model.num_vertices,
            "num_triangles": model.num_triangles}


def convert_lm3d(mat_path: str, out_path: str) -> Dict:
    from voicepuppet_torch.tools.bfm_tools import load_lm3d

    lm3d = load_lm3d(os.path.dirname(mat_path))
    np.save(out_path, lm3d)
    return {"shape": list(lm3d.shape)}


def validate_torch_prep(path: str, model_name: str) -> Dict:
    """Data-prep torch checkpoints (make_data_from_GRID.py:505-510) are
    consumed natively by torch — validate the load instead of converting
    (fail-loud against the framework's module: a renamed or differently-
    shaped release raises in models_torch._load_torch_state)."""
    from voicepuppet_torch.tools import models_torch as mt

    model = getattr(mt, model_name)().eval()
    matched = model.load_state(path)
    return {"status": "validated", "matched_params": matched}


def convert_all(assets_dir: str, out_dir: str, cfg=None) -> Dict:
    """Sweep ``assets_dir`` and convert every recognized asset into
    ``out_dir``.  Returns the manifest dict; never raises for a missing
    or broken asset (per-asset status: converted | validated | missing |
    failed)."""
    if cfg is None:
        from voicepuppet_torch.config import Config
        cfg = Config()
    os.makedirs(out_dir, exist_ok=True)
    manifest: Dict[str, Dict] = {}

    def run(name: str, source, fn, *outputs):
        if source is None:
            manifest[name] = {"status": "missing"}
            return
        try:
            info = dict(fn())
        except Exception as exc:  # manifest captures the reason
            manifest[name] = {"status": "failed", "source": source,
                              "error": f"{type(exc).__name__}: {exc}"}
            return
        status = info.pop("status", "converted")
        manifest[name] = {"status": status, "source": source,
                          "outputs": list(outputs), **info}

    bfm_src = (find_file(assets_dir, BFM_MAT)
               or find_file(assets_dir, "01_MorphableModel.mat"))
    run("bfm", bfm_src, lambda: convert_bfm(assets_dir, out_dir), BFM_MAT)

    lm3d_src = find_file(assets_dir, "similarity_Lm3D_all.mat")
    lm3d_out = os.path.join(out_dir, LM3D_NPY)
    run("lm3d", lm3d_src, lambda: convert_lm3d(lm3d_src, lm3d_out),
        LM3D_NPY)

    bfm_ckpt = find_checkpoint_prefix(assets_dir, "bfmnet")
    bfm_out = os.path.join(out_dir, BFMNET_NPZ)
    run("bfmnet_ckpt", bfm_ckpt,
        lambda: convert_bfmnet(bfm_ckpt, bfm_out, cfg), BFMNET_NPZ)

    px_ckpt = find_checkpoint_prefix(assets_dir, "pixrefernet")
    g_out = os.path.join(out_dir, PIXREFER_G_NPZ)
    d_out = os.path.join(out_dir, PIXREFER_D_NPZ)
    run("pixrefer_ckpt", px_ckpt,
        lambda: convert_pixrefer(px_ckpt, g_out, d_out, cfg),
        PIXREFER_G_NPZ, PIXREFER_D_NPZ)

    vgg_src = find_file(assets_dir, "vgg_16.ckpt")  # V1 single file
    if vgg_src is None:  # or a V2 bundle prefix
        vgg_index = find_file(assets_dir, "vgg_16.ckpt.index")
        vgg_src = vgg_index[:-len(".index")] if vgg_index else None
    vgg_out = os.path.join(out_dir, VGG_NPZ)
    run("vgg16_ckpt", vgg_src, lambda: convert_vgg(vgg_src, vgg_out),
        VGG_NPZ)

    rnet_src = find_file(assets_dir, "FaceReconModel.pb")
    rnet_out = os.path.join(out_dir, RNET_NPZ)
    run("rnet_pb", rnet_src, lambda: convert_rnet(rnet_src, rnet_out),
        RNET_NPZ)

    seg_src = find_file(assets_dir, "mobilenetV2_model_checkpoint_metric.pth")
    run("seg_checkpoint", seg_src,
        lambda: validate_torch_prep(seg_src, "UnetMobilenetV2"))

    dim_src = find_file(assets_dir, "BEST_checkpoint.tar")
    run("matting_checkpoint", dim_src,
        lambda: validate_torch_prep(dim_src, "DIMMatting"))

    return manifest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert the reference's released binary assets "
                    "(allmodels/) into framework-native artifacts, with "
                    "no TensorFlow installed.")
    p.add_argument("--assets_dir", required=True,
                   help="directory holding the released assets "
                        "(the reference's allmodels/ layout; searched "
                        "recursively)")
    p.add_argument("--out_dir", required=True,
                   help="output model dir (created; becomes a drop-in "
                        "cfg.model_dir)")
    p.add_argument("--config", default=None,
                   help="params.yml to size the models for shape "
                        "validation (default: built-in reference config)")
    args = p.parse_args(argv)

    from voicepuppet_torch.config import load_config
    cfg = load_config(args.config)
    manifest = convert_all(args.assets_dir, args.out_dir, cfg)
    path = os.path.join(args.out_dir, "manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)

    failed: List[str] = []
    for name in sorted(manifest):
        entry = manifest[name]
        line = f"{name:15s} {entry['status']}"
        if entry["status"] == "converted":
            line += " -> " + ", ".join(entry["outputs"])
        elif entry["status"] == "failed":
            line += "  " + entry["error"]
            failed.append(name)
        print(line)
    print(f"manifest: {path}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
