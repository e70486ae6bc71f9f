"""Parameter bridge: JAX parameter trees -> this package's state_dicts.

The JAX package stores parameters as nested dicts (flax variables); the
port's modules keep the flax scope names, so a JAX path maps onto a
state_dict key one to one, with these layout changes:

  * Dense ``kernel [in, out]``            -> ``weight [out, in]``
  * Conv ``kernel`` HWIO                  -> ``weight`` OIHW (the depthwise
    ``feature_group_count`` convs included: ``[kh, kw, 1, C]`` ->
    ``[C, 1, kh, kw]``)
  * flax ``ConvTranspose`` ``kernel [kh, kw, in, out]``
    (``transpose_kernel=False``: a plain correlation over the dilated
    input) -> torch ``ConvTranspose2d`` ``weight [in, out, kh, kw]``, which
    is the gradient of a conv and so correlates with the spatially flipped
    kernel: the kernel is flipped in both spatial axes
  * ``TFBatchNorm`` ``params/.../BatchNorm_0/bias`` and
    ``batch_stats/.../BatchNorm_0/{mean,var}`` -> ``bias``,
    ``running_mean``, ``running_var`` (the ``BatchNorm_0`` scope is folded
    into ``TFBatchNorm``)
  * ``StatelessBatchNorm`` ``scale`` -> ``weight``

The same rules carry every parameter tree the trainers hold: BFMNet's
``batch_stats``, the discriminator's params, the VGG trunk's
``conv{i}_{j}`` and the optax Adam state (``mu``/``nu`` trees and the
update count; :func:`adam_state_from_optax`).  :func:`flax_from_state_dict`
and :func:`adam_state_to_flax` go back.

Leaves may be numpy arrays or anything ``np.asarray`` takes.  The same
rule serves the TF-named loaders (``tools/tf_checkpoint.py``): a TF
variable is first put into its JAX layout and path, then through
:func:`state_key_for` and :func:`convert_leaf`; :func:`flax_leaf` is the
inverse used by the exports.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_COLLECTIONS = ("params", "batch_stats")
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (str(key),))
        else:
            yield path + (str(key),), np.asarray(value)


def convert_leaf(path: Tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """One JAX leaf -> the torch layout of the matching parameter."""
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:
        return value.T
    if value.ndim == 4 and len(path) > 1 and path[-2].startswith(
            "ConvTranspose"):
        return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    if value.ndim == 4:
        return np.transpose(value, (3, 2, 0, 1))
    raise ValueError(f"unexpected kernel rank {value.ndim} at "
                     f"{'/'.join(path)}")


def flax_leaf(path: Tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """The inverse of :func:`convert_leaf`: a torch-layout parameter -> the
    JAX leaf at ``path``."""
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:
        return value.T
    if value.ndim == 4 and len(path) > 1 and path[-2].startswith(
            "ConvTranspose"):
        return np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]
    if value.ndim == 4:
        return np.transpose(value, (2, 3, 1, 0))
    raise ValueError(f"unexpected kernel rank {value.ndim} at "
                     f"{'/'.join(path)}")


def state_key_for(path: Tuple[str, ...]) -> str:
    """The state_dict key of the JAX leaf at ``path`` (a tuple of scope
    names ending in the leaf name, without the collection)."""
    if path[-1] not in _LEAF_NAMES:
        raise KeyError(f"unmapped leaf {'/'.join(path)}")
    mods = [p for p in path[:-1] if p != "BatchNorm_0"]
    return ".".join(mods + [_LEAF_NAMES[path[-1]]])


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (``{"params": ..., "batch_stats": ...}``) or a bare
    params tree -> a state_dict keyed like the port's modules."""
    top = set(tree)
    roots = ([tree[c] for c in _COLLECTIONS if c in tree]
             if top & set(_COLLECTIONS) else [tree])
    out: Dict[str, torch.Tensor] = {}
    for root in roots:
        for path, value in _leaves(root):
            out[state_key_for(path)] = torch.from_numpy(np.ascontiguousarray(
                convert_leaf(path, value), dtype=np.float32))
    return out


def check_state_dict(own: Mapping[str, torch.Tensor],
                     state: Mapping[str, torch.Tensor], what: str):
    """Raise a ``ValueError`` naming the first three missing, unexpected
    and mis-shaped entries of ``state`` against a module's own state_dict
    ``own``; a partial state_dict is never loaded."""
    missing = [k for k in own if k not in state]
    unexpected = [k for k in state if k not in own]
    shaped = [f"{k} {tuple(state[k].shape)} vs {tuple(own[k].shape)}"
              for k in state if k in own and own[k].shape != state[k].shape]
    problems = [f"{len(v)} {label}, e.g. {v[:3]}" for label, v in (
        ("missing", missing), ("unexpected", unexpected),
        ("mis-shaped", shaped)) if v]
    if problems:
        raise ValueError(f"{what}: " + "; ".join(problems))


def load_flax_(module: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load a flax tree into ``module``, failing on any missing,
    unexpected or mis-shaped entry."""
    state = state_dict_from_flax(tree)
    own = module.state_dict()
    bad = [k for k in state if k in own and own[k].shape != state[k].shape]
    if bad:
        raise ValueError("shape mismatch: " + ", ".join(
            f"{k} {tuple(state[k].shape)} vs {tuple(own[k].shape)}"
            for k in bad[:5]))
    module.load_state_dict(state, strict=True)
    return module


def flax_from_state_dict(state: Mapping[str, torch.Tensor],
                         template: Mapping) -> Dict:
    """A state_dict -> the JAX tree shaped like ``template`` (flax
    variables or a bare params tree; only its paths are read), as numpy
    arrays: the inverse of :func:`state_dict_from_flax`."""
    def build(tree, path):
        return {k: build(v, path + (k,)) if isinstance(v, Mapping)
                else flax_leaf(path + (k,), state[state_key_for(
                    path + (k,))].detach().cpu().float().numpy())
                for k, v in tree.items()}
    if set(template) & set(_COLLECTIONS):
        return {c: build(template[c], ()) for c in _COLLECTIONS
                if c in template}
    return build(template, ())


def _find_adam(opt_state) -> Any:
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_adam(sub)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state) -> Dict[str, Any]:
    """An optax ``chain([clip_by_global_norm,] adam(schedule))`` state ->
    ``{"count": int, "mu": state_dict, "nu": state_dict}`` for
    :func:`load_adam_state_`."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    return {"count": int(np.asarray(adam.count)),
            "mu": state_dict_from_flax(adam.mu),
            "nu": state_dict_from_flax(adam.nu)}


def load_adam_state_(optimizer: torch.optim.Optimizer,
                     module: torch.nn.Module, adam: Mapping[str, Any]):
    """Put ``adam`` (:func:`adam_state_from_optax`) into a port
    ``ReferenceAdam`` over ``module.parameters()``."""
    for name, p in module.named_parameters():
        optimizer.state[p] = {
            "mu": adam["mu"][name].to(p.device, p.dtype).clone(),
            "nu": adam["nu"][name].to(p.device, p.dtype).clone()}
    for group in optimizer.param_groups:
        group["count"] = int(adam["count"])


def adam_state_to_flax(optimizer: torch.optim.Optimizer,
                       module: torch.nn.Module, template: Mapping
                       ) -> Dict[str, Any]:
    """A port ``ReferenceAdam``'s state -> ``{"count", "mu", "nu"}`` with
    ``mu``/``nu`` shaped like the params tree ``template``."""
    names = dict(module.named_parameters())
    moments = {m: flax_from_state_dict(
        {n: optimizer.state[p][m] for n, p in names.items()}, template)
        for m in ("mu", "nu")}
    return {"count": optimizer.param_groups[0]["count"], **moments}
