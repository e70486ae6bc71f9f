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
    kernel: the kernel is flipped in both spatial axes.  A transposed conv
    is recognised by flax's own scope name, ``ConvTranspose_<i>``, or,
    where the parent names it, by the target module: the functions given
    a ``module`` treat the weight of each ``nn.ConvTranspose2d`` in it so.
    Its ``'SAME'`` padding is ``layers.SameConvTranspose2d``'s business:
    4 before and 3 after at k=7 s=2, which torch reaches by ``padding=2``
    and a crop of the last row and column
  * ``TFBatchNorm`` ``params/.../BatchNorm_0/bias`` and
    ``batch_stats/.../BatchNorm_0/{mean,var}`` -> ``bias``,
    ``running_mean``, ``running_var`` (the ``BatchNorm_0`` scope is folded
    into ``TFBatchNorm``)
  * ``StatelessBatchNorm`` ``scale`` -> ``weight``; VGNet's
    ``StatelessCenterBN`` holds a lone ``bias``, which maps as any bias
  * ``nn.scan`` cells keep their flax scope (``ScanTFGRUCell_0``,
    VGNet's ``ScanConv2dGRUCell_0``): the scanned cell's parameters are
    shared over time, so they are one module's

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

from typing import (Any, Dict, FrozenSet, Iterator, Mapping, Optional,
                    Tuple)

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


def transposed_keys(module: Optional[torch.nn.Module]) -> FrozenSet[str]:
    """The state_dict keys of the weights of ``module``'s transposed
    convs (none without a module)."""
    if module is None:
        return frozenset()
    return frozenset(f"{name}.weight" if name else "weight"
                     for name, m in module.named_modules()
                     if isinstance(m, torch.nn.ConvTranspose2d))


def _is_transpose(path: Tuple[str, ...], transposed: FrozenSet[str]) -> bool:
    return len(path) > 1 and (path[-2].startswith("ConvTranspose")
                              or state_key_for(path) in transposed)


def convert_leaf(path: Tuple[str, ...], value: np.ndarray,
                 transposed: FrozenSet[str] = frozenset()) -> np.ndarray:
    """One JAX leaf -> the torch layout of the matching parameter
    (``transposed``: :func:`transposed_keys` of the target module)."""
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:
        return value.T
    if value.ndim == 4 and _is_transpose(path, transposed):
        return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    if value.ndim == 4:
        return np.transpose(value, (3, 2, 0, 1))
    raise ValueError(f"unexpected kernel rank {value.ndim} at "
                     f"{'/'.join(path)}")


def flax_leaf(path: Tuple[str, ...], value: np.ndarray,
              transposed: FrozenSet[str] = frozenset()) -> np.ndarray:
    """The inverse of :func:`convert_leaf`: a torch-layout parameter -> the
    JAX leaf at ``path``."""
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:
        return value.T
    if value.ndim == 4 and _is_transpose(path, transposed):
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


def flax_paths(module: torch.nn.Module) -> Dict[str, Tuple[str, ...]]:
    """The JAX path of each of ``module``'s parameters, by state_dict
    key: the inverse of :func:`state_key_for` on parameters.  A
    ``weight`` is a ``kernel`` (a Dense or a conv, two or four axes) or a
    norm's ``scale`` (one axis); a module with a ``flax_scope``
    (``TFBatchNorm``) puts its parameters under that scope."""
    out = {}
    for mod_name, mod in module.named_modules():
        scope = tuple(mod_name.split(".")) if mod_name else ()
        inner = getattr(mod, "flax_scope", None)
        scope += (inner,) if inner else ()
        for name, p in mod.named_parameters(recurse=False):
            leaf = ("bias" if name == "bias" else "scale" if p.dim() == 1
                    else "kernel")
            key = f"{mod_name}.{name}" if mod_name else name
            path = scope + (leaf,)
            if state_key_for(path) != key:
                raise KeyError(f"{key}: no JAX path maps onto it")
            out[key] = path
    return out


def state_dict_from_flax(tree: Mapping,
                         module: Optional[torch.nn.Module] = None
                         ) -> Dict[str, torch.Tensor]:
    """flax variables (``{"params": ..., "batch_stats": ...}``) or a bare
    params tree -> a state_dict keyed like the port's modules; ``module``,
    the target, names the transposed convs flax's scopes do not."""
    transposed = transposed_keys(module)
    top = set(tree)
    roots = ([tree[c] for c in _COLLECTIONS if c in tree]
             if top & set(_COLLECTIONS) else [tree])
    out: Dict[str, torch.Tensor] = {}
    for root in roots:
        for path, value in _leaves(root):
            out[state_key_for(path)] = torch.from_numpy(np.ascontiguousarray(
                convert_leaf(path, value, transposed), np.float32))
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
    state = state_dict_from_flax(tree, module)
    own = module.state_dict()
    bad = [k for k in state if k in own and own[k].shape != state[k].shape]
    if bad:
        raise ValueError("shape mismatch: " + ", ".join(
            f"{k} {tuple(state[k].shape)} vs {tuple(own[k].shape)}"
            for k in bad[:5]))
    module.load_state_dict(state, strict=True)
    return module


def flax_from_state_dict(state: Mapping[str, torch.Tensor],
                         template: Mapping,
                         module: Optional[torch.nn.Module] = None) -> Dict:
    """A state_dict -> the JAX tree shaped like ``template`` (flax
    variables or a bare params tree; only its paths are read), as numpy
    arrays: the inverse of :func:`state_dict_from_flax`."""
    transposed = transposed_keys(module)

    def build(tree, path):
        return {k: build(v, path + (k,)) if isinstance(v, Mapping)
                else flax_leaf(path + (k,), state[state_key_for(
                    path + (k,))].detach().cpu().float().numpy(), transposed)
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


def adam_state_from_optax(opt_state,
                          module: Optional[torch.nn.Module] = None
                          ) -> Dict[str, Any]:
    """An optax ``chain([clip_by_global_norm,] adam(schedule))`` state ->
    ``{"count": int, "mu": state_dict, "nu": state_dict}`` for
    :func:`load_adam_state_` (``module``: as for
    :func:`state_dict_from_flax`)."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    return {"count": int(np.asarray(adam.count)),
            "mu": state_dict_from_flax(adam.mu, module),
            "nu": state_dict_from_flax(adam.nu, module)}


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
        {n: optimizer.state[p][m] for n, p in names.items()}, template,
        module)
        for m in ("mu", "nu")}
    return {"count": optimizer.param_groups[0]["count"], **moments}
