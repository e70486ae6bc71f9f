"""The reference's TF variable names -> the port's state_dict keys.

Port of ``voicepuppet_tpu/tools/tf_checkpoint.py``.  Each row of a name
map is ``(tf_name, collection, flax_path, transform)``: the TF variable,
the JAX collection and parameter path it fills, and the layout change
from TF to that JAX leaf (``None``, or one of the two involutions below).
The path is only a tuple of scope names: ``weights.state_key_for`` turns
it into the port's key and ``weights.convert_leaf`` the JAX leaf into the
torch layout, so TF -> torch is one composition of two rules:

  * conv kernels: TF HWIO == JAX HWIO -> torch OIHW
  * depthwise kernels: TF ``[H, W, C, 1]`` -> JAX ``[H, W, 1, C]`` ->
    torch ``[C, 1, H, W]``
  * ``conv2d_transpose`` kernels: TF ``[H, W, out, in]`` -> JAX
    ``ConvTranspose`` ``[H, W, in, out]`` -> torch ``[in, out, H, W]``,
    flipped in both spatial axes
  * dense kernels: TF ``[in, out]`` == JAX -> torch ``[out, in]``
  * batch norm: ``beta`` -> ``bias``, ``moving_mean``/``moving_variance``
    -> ``running_mean``/``running_var``; PixRefer's ``gamma`` -> ``weight``

The loaders return ``(state, loaded, missing)`` like the JAX ones; the
serving entry points go through :func:`strict_state`, which raises a
``ValueError`` naming the first three missing, unexpected or mis-shaped
variables, so a partial state_dict is never loaded.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from voicepuppet_torch import weights
from voicepuppet_torch.tools.tf_bundle import read_checkpoint

Row = Tuple[str, str, Tuple[str, ...], Optional[Callable]]

# reference MfccNet block schedule (tinynet.py:169-207): scope name and
# whether the stem/head ConvBN or an inverted-residual block
_MFCCNET_SCOPES = (
    ("block0_0", "conv"),
    ("block1_0", "ir"), ("block2_0", "ir"), ("block2_1", "ir"),
    ("block3_0", "ir"), ("block3_1", "ir"), ("block3_2", "ir"),
    ("block4_0", "ir"), ("block4_1", "ir"), ("block4_2", "ir"),
    ("block4_3", "ir"),
    ("block5_0", "ir"), ("block5_1", "ir"), ("block5_2", "ir"),
    ("block6_0", "ir"), ("block6_1", "ir"), ("block6_2", "ir"),
    ("block7_0", "ir"),
    ("block8_0", "conv"),
)


def _bn_entries(tf_scope: str, flax_prefix: Tuple[str, ...]) -> List[Row]:
    """tf.contrib.layers.batch_norm variables under ``tf_scope``."""
    bn = flax_prefix + ("BatchNorm_0",)
    return [
        (f"{tf_scope}/BatchNorm/beta", "params", bn + ("bias",), None),
        (f"{tf_scope}/BatchNorm/moving_mean", "batch_stats",
         bn + ("mean",), None),
        (f"{tf_scope}/BatchNorm/moving_variance", "batch_stats",
         bn + ("var",), None),
    ]


def _depthwise(x: np.ndarray) -> np.ndarray:
    """[H, W, C, 1] <-> [H, W, 1, C] (an involution)."""
    return np.transpose(x, (0, 1, 3, 2))


def _deconv(x: np.ndarray) -> np.ndarray:
    """TF conv2d_transpose ``[H, W, out, in]`` <-> JAX ConvTranspose
    ``[H, W, in, out]`` (an involution)."""
    return np.transpose(x, (0, 1, 3, 2))


def bfmnet_name_map() -> List[Row]:
    """Rows for BFMNet, shortcut convs excepted (:func:`_shortcut_rows`)."""
    rows: List[Row] = []
    conv_i = 0
    ir_i = 0
    net = ("mfcc_encoder", "MfccNet_0")
    for scope, kind in _MFCCNET_SCOPES:
        tf_base = f"mfcc_encoder/MfccNet/{scope}"
        if kind == "conv":
            p = net + (f"ConvBN_{conv_i}",)
            rows.append((f"{tf_base}/conv2d/conv2d/kernel", "params",
                         p + ("Conv_0", "kernel"), None))
            rows += _bn_entries(f"{tf_base}/conv2d", p + ("TFBatchNorm_0",))
            conv_i += 1
        else:
            p = net + (f"InvertedResidual_{ir_i}",)
            rows.append((f"{tf_base}/expansion_1x1_conv2d/conv2d/kernel",
                         "params", p + ("Conv_0", "kernel"), None))
            rows += _bn_entries(f"{tf_base}/expansion_1x1_conv2d",
                                p + ("TFBatchNorm_0",))
            # tf.contrib.layers.separable_conv2d names its kernel
            # 'depthwise_weights' [H, W, C, 1] under 'SeparableConv2d'
            rows.append((f"{tf_base}/depthwise_conv2d/SeparableConv2d/"
                         "depthwise_weights", "params",
                         p + ("Conv_1", "kernel"), _depthwise))
            rows += _bn_entries(f"{tf_base}/depthwise_conv2d",
                                p + ("TFBatchNorm_1",))
            rows.append((f"{tf_base}/projection_1x1_conv2d/conv2d/kernel",
                         "params", p + ("Conv_2", "kernel"), None))
            rows += _bn_entries(f"{tf_base}/projection_1x1_conv2d",
                                p + ("TFBatchNorm_2",))
            ir_i += 1
    gru = "rnn_module/rnn/multi_rnn_cell/cell_0/gru_cell"
    cell = ("rnn_module", "ScanTFGRUCell_0")
    for tf_name, path in (
            ("mfcc_encoder/dense", ("mfcc_encoder", "Dense_0")),
            ("rnn_module/dense", ("rnn_in",)),
            (f"{gru}/gates", cell + ("Dense_0",)),
            (f"{gru}/candidate", cell + ("Dense_1",)),
            ("bfm_coeff_decoder/dense", ("bfm_coeff_decoder", "Dense_0")),
            ("bfm_coeff_decoder/dense_1", ("bfm_coeff_decoder", "Dense_1")),
            ("bfm_coeff_decoder/dense_2", ("bfm_coeff_decoder", "Dense_2"))):
        rows.append((f"{tf_name}/kernel", "params", path + ("kernel",), None))
        rows.append((f"{tf_name}/bias", "params", path + ("bias",), None))
    return rows


def _own(target) -> Mapping[str, torch.Tensor]:
    return (target.state_dict() if isinstance(target, torch.nn.Module)
            else target)


def _shortcut_rows(target) -> List[Row]:
    """Inverted residuals whose channel count changes carry a 1x1 + BN
    shortcut (``Conv_3``/``TFBatchNorm_3``), named by the block's
    ``1x1_conv2d`` scope in TF (tinynet.py:29-44).  Which blocks have one
    is read off the target's own keys (a module or a state_dict)."""
    keys = _own(target)
    rows: List[Row] = []
    ir_i = 0
    for scope, kind in _MFCCNET_SCOPES:
        if kind != "ir":
            continue
        p = ("mfcc_encoder", "MfccNet_0", f"InvertedResidual_{ir_i}")
        if weights.state_key_for(p + ("Conv_3", "kernel")) in keys:
            tf_base = f"mfcc_encoder/MfccNet/{scope}/1x1_conv2d"
            rows.append((f"{tf_base}/conv2d/kernel", "params",
                         p + ("Conv_3", "kernel"), None))
            rows += _bn_entries(tf_base, p + ("TFBatchNorm_3",))
        ir_i += 1
    return rows


def bfmnet_rows(target) -> List[Row]:
    """Every BFMNet row for ``target`` (a BFMNet or its state_dict)."""
    return bfmnet_name_map() + _shortcut_rows(target)


def pixrefer_generator_name_map() -> List[Row]:
    """Rows for the PixRefer generator (scopes of pixrefer.py:166-277; the
    ``StatelessBatchNorm_{i}`` numbering follows creation order).  The
    reference's BN moving statistics are dead state (it always normalizes
    with batch moments), so they have no row."""
    g = ("generator",)
    rows: List[Row] = []
    bn_i = 0

    def conv(scope, kind="conv2d"):
        transform = _deconv if kind == "conv2d_transpose" else None
        layer = "Conv_0" if kind == "conv2d" else "ConvTranspose_0"
        rows.append((f"generator/{scope}/{kind}/kernel", "params",
                     g + (scope, layer, "kernel"), transform))
        rows.append((f"generator/{scope}/{kind}/bias", "params",
                     g + (scope, layer, "bias"), None))

    def bn(scope):
        nonlocal bn_i
        base = f"generator/{scope}/batch_normalization"
        rows.append((f"{base}/gamma", "params",
                     g + (f"StatelessBatchNorm_{bn_i}", "scale"), None))
        rows.append((f"{base}/beta", "params",
                     g + (f"StatelessBatchNorm_{bn_i}", "bias"), None))
        bn_i += 1

    conv("encoder_1")
    for i in (2, 3, 4):
        conv(f"encoder_{i}")
        bn(f"encoder_{i}")
    conv("encoder_fg_1")
    for i in (2, 3, 4):
        conv(f"encoder_fg_{i}")
        bn(f"encoder_fg_{i}")
    for i in (2, 3, 4, 5):
        conv(f"merged_encoder_{i}")
        bn(f"merged_encoder_{i}")
    for i in (5, 4, 3, 2):      # creation order (pixrefer.py:233-248)
        conv(f"merged_decoder_{i}", "conv2d_transpose")
        bn(f"merged_decoder_{i}")
    for i in (4, 3, 2):         # creation order (pixrefer.py:257-267)
        conv(f"merged2_decoder_{i}", "conv2d_transpose")
        bn(f"merged2_decoder_{i}")
    conv("decoder_1", "conv2d_transpose")
    return rows


def pixrefer_discriminator_name_map() -> List[Row]:
    """Rows for the PatchGAN discriminator (pixrefer.py:103-134) into
    ``models.pixrefer.Discriminator``, whose keys follow the JAX tree
    (``layer_{i}.Conv_0``, ``StatelessBatchNorm_{k}``)."""
    rows: List[Row] = []
    bn_i = 0
    for i in range(1, 6):
        rows.append((f"discriminator/layer_{i}/conv2d/kernel", "params",
                     (f"layer_{i}", "Conv_0", "kernel"), None))
        rows.append((f"discriminator/layer_{i}/conv2d/bias", "params",
                     (f"layer_{i}", "Conv_0", "bias"), None))
        if i in (2, 3, 4):
            base = f"discriminator/layer_{i}/batch_normalization"
            rows.append((f"{base}/gamma", "params",
                         (f"StatelessBatchNorm_{bn_i}", "scale"), None))
            rows.append((f"{base}/beta", "params",
                         (f"StatelessBatchNorm_{bn_i}", "bias"), None))
            bn_i += 1
    return rows


def _to_state(row: Row, value: np.ndarray) -> Tuple[str, torch.Tensor]:
    """One TF array -> (state_dict key, torch-layout float32 tensor)."""
    _, _, path, transform = row
    if transform is not None:
        value = transform(value)
    return weights.state_key_for(path), torch.from_numpy(np.array(
        weights.convert_leaf(path, np.asarray(value)), np.float32,
        order="C"))


def export_arrays(state: Mapping[str, torch.Tensor],
                  rows: List[Row]) -> Dict[str, np.ndarray]:
    """A state_dict -> ``{tf_name: array}`` in TF's layouts (the inverse of
    the loaders), for every row whose key the state holds."""
    out: Dict[str, np.ndarray] = {}
    for tf_name, _coll, path, transform in rows:
        key = weights.state_key_for(path)
        if key not in state:
            continue
        val = weights.flax_leaf(path, state[key].detach().cpu().float()
                                .numpy())
        if transform is not None:
            val = transform(val)
        out[tf_name] = np.ascontiguousarray(val, np.float32)
    return out


def export_npz(state: Mapping[str, torch.Tensor], rows: List[Row],
               path: str):
    """A state_dict -> a TF-named npz (``/`` escaped as ``|`` in keys)."""
    np.savez(path, **{k.replace("/", "|"): v
                      for k, v in export_arrays(state, rows).items()})


def export_bfmnet_npz(state: Mapping[str, torch.Tensor], path: str):
    export_npz(state, bfmnet_rows(state), path)


def load_arrays(available: Mapping[str, np.ndarray], target,
                rows: List[Row]):
    """TF-named arrays -> ``(state, loaded, missing)`` for ``target`` (a
    module or its state_dict): ``state`` holds each row whose variable is
    present and whose converted shape matches the target's; every other
    row's TF name is in ``missing``."""
    own = _own(target)
    state: Dict[str, torch.Tensor] = {}
    loaded, missing = [], []
    for row in rows:
        tf_name = row[0]
        if tf_name not in available:
            missing.append(tf_name)
            continue
        key, value = _to_state(row, available[tf_name])
        if key not in own or own[key].shape != value.shape:
            missing.append(tf_name)
            continue
        state[key] = value
        loaded.append(tf_name)
    return state, loaded, missing


def strict_state(available: Mapping[str, np.ndarray], target,
                 rows: List[Row], what: str) -> Dict[str, torch.Tensor]:
    """TF-named arrays -> a complete state_dict for ``target``, or a
    ``ValueError`` naming the first three variables missing from
    ``available`` and the first three missing, unexpected or mis-shaped
    state_dict entries."""
    absent = [r[0] for r in rows if r[0] not in available]
    state = dict(_to_state(r, available[r[0]]) for r in rows
                 if r[0] in available)
    try:
        weights.check_state_dict(_own(target), state, what)
    except ValueError as err:
        if absent:
            raise ValueError(f"{what}: {len(absent)} variables absent, "
                             f"e.g. {absent[:3]}; {err}") from None
        raise
    if absent:
        raise ValueError(f"{what}: {len(absent)} variables absent, "
                         f"e.g. {absent[:3]}")
    return state


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """A TF-named npz (``|`` for ``/``) -> ``{tf_name: array}``."""
    blob = np.load(path)
    return {k.replace("|", "/"): blob[k] for k in blob.files}


def load_npz(path: str, target, rows: List[Row]):
    return load_arrays(read_npz(path), target, rows)


def load_ckpt(prefix: str, target, rows: List[Row],
              verify_crc: bool = False):
    """A TF checkpoint (V2 bundle prefix or V1 file), read with no
    TensorFlow -> ``(state, loaded, missing)``."""
    return load_arrays(read_checkpoint(prefix, verify_crc=verify_crc),
                       target, rows)


def load_bfmnet_ckpt(prefix: str, target, verify_crc: bool = False):
    """``ckpt_bfmnet/bfmnet-65000``-shaped checkpoint -> BFMNet state."""
    return load_ckpt(prefix, target, bfmnet_rows(target), verify_crc)


def load_bfmnet_npz(path: str, target):
    return load_npz(path, target, bfmnet_rows(target))


def load_pixrefer_ckpt(prefix: str, g_target, d_target=None,
                       verify_crc: bool = False):
    """``ckpt_pixrefer/pixrefernet-20000``-shaped checkpoint -> ((g_state,
    loaded, missing), (d_state, loaded, missing) or None)."""
    arrays = read_checkpoint(prefix, verify_crc=verify_crc)
    g = load_arrays(arrays, g_target, pixrefer_generator_name_map())
    d = (load_arrays(arrays, d_target, pixrefer_discriminator_name_map())
         if d_target is not None else None)
    return g, d
