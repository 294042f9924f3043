"""Weights and optimizer state carried across between the JAX package's
trees and the port, both ways.

The reference keeps its parameters as a pytree of arrays with the layers
stacked along a leading ``n_layers`` dim:

  embed (padded_vocab, D)          norm_f (D,)      head (D, padded_vocab)
  layers/attn/{wq,wk,wv,wo}        (L, in, out)     [head absent when tied,
                                                     embed for audio]
  layers/ffn/{w_gate,w_up,w_down}  (L, in, out)     [dense family]
  layers/norm_attn, layers/norm_ffn (L, D)

and for the moe family, in place of ``ffn``, the router and the expert
stacks ``layers/moe/{router,w_down,w_gate,w_up}`` (L, D, E) and
(L, E, in, out), with the shared experts' ``layers/shared/{w_down,
w_gate,w_up}`` (L, in, out); with MLA, ``layers/attn/{w_dkv,w_kr,w_uk,
w_uv,wo,wq}`` (L, in, out). The ssm family's layers are
``layers/mamba/{A_log,D_skip,conv_b,conv_w,dt_bias,in_proj,out_proj}``
and ``layers/norm``; the hybrid family adds the one shared attention
block, not stacked: ``shared/attn/{wq,wk,wv,wo}``, ``shared/ffn/...``,
``shared/norm_attn`` and ``shared/norm_ffn``. A leaf's path is its port
parameter's name with the dots as slashes and the norms' ``.gamma``
dropped (and the layer's index dropped from a stacked leaf).

:func:`params_from_reference` takes that tree as nested dicts of numpy
arrays (the caller converts; nothing here imports the reference) and
loads it into the family's module (``registry.model_class``). Both
packages use the ``(in, out)`` layout of ``x @ w``, so nothing is
transposed. :func:`cache_from_reference` does the same for a decode
cache: GQA's ``{"k", "v"}`` of shape (L, B, max_len, KV, hd), MLA's
``{"c_kv", "k_rope"}`` of shape (L, B, max_len, r) and (L, B, max_len,
qk_rope), the ssm family's ``{"state", "conv"}`` of shape (L, B, H, hd,
N) and (L, B, W - 1, C), the hybrid family's ``{"attn": {"k", "v"},
"ssm": {"state", "conv"}}`` with one attention slot per segment.

The other direction, :func:`params_to_reference`, gives the port's model
as that stacked tree of numpy arrays; :func:`opt_to_reference` and
:func:`opt_from_reference` do the same for optimizer state (AdamW
``step`` / ``m`` / ``v``, Adafactor ``step`` / ``stats``). The slots and
the checksum ledger use the reference's leaves, in ``jax.tree.leaves``
order, through :func:`reference_paths` and :func:`reference_tree`, so
that a slot or a ledger record written by either package reads in the
other.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import get_device
from ..optim.adamw import AdafactorState, AdamWState
from .registry import family_module, model_class

__all__ = ["params_from_reference", "cache_from_reference",
           "params_to_reference", "opt_to_reference", "opt_from_reference",
           "opt_tree", "reference_paths", "reference_tree", "nest", "tree_items",
           "to_host", "param_axes"]

@functools.lru_cache(maxsize=None)
def _leaves(cfg: ModelConfig) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(top-level leaves, per-layer leaves), read off a one-layer model on
    the meta device: the reference's leaf path -> the port's parameter
    name ("norm_f" -> "norm_f.gamma", "shared/attn/wq" ->
    "shared.attn.wq"), and for a stacked leaf (under "layers/") -> the
    attribute path inside one layer ("layers/attn/wq" -> "attn.wq")."""
    one = model_class(cfg)(dataclasses.replace(cfg, n_layers=1),
                           device="meta")
    top, layer = {}, {}
    for name, _ in one.named_parameters():
        path = name.removesuffix(".gamma").replace(".", "/")
        if name.startswith("layers.0."):
            layer["layers/" + path[len("layers/0/"):]] = \
                name[len("layers.0."):]
        else:
            top[path] = name
    return top, layer


def reference_paths(cfg: ModelConfig) -> List[Tuple[str, List[str]]]:
    """[(the reference's leaf path, the port's parameter names)] in the
    order ``jax.tree.leaves`` gives the reference's parameters (dict keys
    sorted at every level, which for these keys is the order of the
    whole paths). A stacked layer leaf maps to one name per layer."""
    top, layer = _leaves(cfg)
    out = [(k, [v]) for k, v in top.items()]
    out += [(k, [f"layers.{i}.{v}" for i in range(cfg.n_layers)])
            for k, v in layer.items()]
    return sorted(out)


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical-axes tree of ``cfg``'s parameters in the reference's
    layout (what its ``init`` returns beside the parameters): each leaf
    the tuple of dim names its module class gives in ``AXES``, a stacked
    layer leaf's prefixed with "layers". ``sharding.partition`` maps the
    names onto a mesh."""
    one = model_class(cfg)(dataclasses.replace(cfg, n_layers=1),
                           device="meta")
    top, layer = _leaves(cfg)
    out = {}
    for path, name in list(top.items()) + [(k, "layers.0." + v)
                                           for k, v in layer.items()]:
        mod, _, attr = name.rpartition(".")
        ax = type(one.get_submodule(mod)).AXES[attr]
        out[path] = ("layers",) + ax if path.startswith("layers/") else ax
    return nest(out)


def nest(flat: Mapping[str, object]) -> Dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out: Dict = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        d = out
        for h in heads:
            d = d.setdefault(h, {})
        d[last] = leaf
    return out


def reference_tree(cfg: ModelConfig, by_name: Mapping[str, object]) -> Dict:
    """The port's per-parameter values (keyed by parameter name) as the
    reference's nested tree: a stacked layer leaf holds the list of its
    layers' values, any other leaf its one value."""
    return nest({path: ([by_name[n] for n in names]
                        if path.startswith("layers/") else by_name[names[0]])
                 for path, names in reference_paths(cfg)})


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of a nested dict / NamedTuple in ``jax.tree.leaves``
    order: dict keys sorted, NamedTuple fields in their order. A list
    (the layers of one stacked leaf) is one leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from tree_items(getattr(tree, k), f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def to_host(leaf) -> np.ndarray:
    """A tensor, or the list of one stacked leaf's layers, as one numpy
    array, each tensor copied once from its device into the array."""
    parts = leaf if isinstance(leaf, list) else [leaf]
    first = parts[0]
    if first.dtype not in _NP_DTYPES:
        raise TypeError(f"no host layout for {first.dtype}")
    shape = tuple(first.shape)
    out = np.empty(((len(parts),) + shape) if isinstance(leaf, list)
                   else shape, dtype=_NP_DTYPES[first.dtype])
    dst = [out] if not isinstance(leaf, list) else list(out)
    for d, t in zip(dst, parts):
        torch.from_numpy(d).copy_(t.detach())
    return out


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return to_host(tree)


def params_to_reference(cfg: ModelConfig, lm) -> Dict:
    """The model's parameters as the reference's stacked tree of numpy
    arrays (``layers/attn/wq`` as (L, in, out), and so on)."""
    return _host_tree(reference_tree(cfg, dict(lm.named_parameters())))


def opt_tree(cfg: ModelConfig, state):
    """Optimizer state in the reference's structure, leaves still the
    port's tensors: AdamWState(step, m, v) with the moments as
    :func:`reference_tree` gives them, AdafactorState(step, stats) with the
    (stacked) statistics nested by path."""
    if isinstance(state, AdamWState):
        return AdamWState(step=state.step, m=reference_tree(cfg, state.m),
                          v=reference_tree(cfg, state.v))
    return AdafactorState(step=state.step, stats=nest(state.stats))


def opt_to_reference(cfg: ModelConfig, state) -> Dict:
    """Optimizer state as the reference's tree of numpy arrays: AdamW
    {"step", "m", "v"} with the moments stacked like the parameters,
    Adafactor {"step", "stats"}."""
    tree = opt_tree(cfg, state)
    return {k: _host_tree(getattr(tree, k)) for k in tree._fields}


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as ``ml_dtypes`` gives them
    from a jax array) as a tensor of ``dtype`` on ``device``."""
    a = np.asarray(a)
    if not a.flags.writeable:   # jax hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _set(param: torch.Tensor, value, where: str) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{where}: reference shape {tuple(value.shape)}, "
                         f"port expects {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(_to_tensor(value, param.dtype, param.device))


def params_from_reference(cfg: ModelConfig, tree: Mapping, device=None):
    """The family's model (``registry.model_class``) on ``device``
    (default :func:`repro_torch.get_device`) holding the reference's
    parameters ``tree``. Raises ValueError on a leaf the configuration
    does not have and on any shape that differs, KeyError on a missing
    leaf (as a torn slot gives)."""
    lm = model_class(cfg)(cfg, device=device if device is not None
                          else get_device())
    flat = dict(tree_items(tree))
    paths = reference_paths(cfg)
    expect = [path for path, _ in paths]
    extra = sorted(set(flat) - set(expect))
    if extra:
        raise ValueError(f"reference tree has {extra}, beyond the expected "
                         f"{expect}")
    missing = [path for path in expect if path not in flat]
    if missing:
        raise KeyError(f"reference tree lacks {missing}")
    params = dict(lm.named_parameters())
    for path, names in paths:
        if not path.startswith("layers/"):
            _set(params[names[0]], flat[path], path)
            continue
        stacked = np.asarray(flat[path])
        if stacked.shape[:1] != (len(names),):
            raise ValueError(f"{path}: shape {stacked.shape}, expected "
                             f"{len(names)} stacked layers")
        for i, name in enumerate(names):
            _set(params[name], stacked[i], f"{path}[{i}]")
    return lm


def cache_from_reference(cfg: ModelConfig, cache: Mapping, device=None):
    """The reference's decode cache as tensors on ``device``, each of the
    type the port's ``init_cache`` gives it (the compute type; an SSM
    state float32): GQA's {"k", "v"} (L, B, max_len, KV, hd), MLA's
    {"c_kv", "k_rope"}, the ssm family's {"state", "conv"}, the hybrid
    family's {"attn": {...}, "ssm": {...}}. Every dim but the batch and
    ``max_len`` must be the configuration's."""
    dev = device if device is not None else get_device()
    init = family_module(cfg).init_cache
    want = dict(tree_items(init(cfg, 1, 1, device="meta")[0]))
    # the dims that follow the batch or max_len differ between the two
    other = dict(tree_items(init(cfg, 2, 3, device="meta")[0]))
    got = dict(tree_items(cache))
    if sorted(got) != sorted(want):
        raise ValueError(f"cache has {sorted(got)}, expected {sorted(want)}")
    out = {}
    for path, like in want.items():
        a = np.asarray(got[path])
        fixed = [(d, n) for d, (n, m) in
                 enumerate(zip(like.shape, other[path].shape)) if n == m]
        if a.ndim != like.ndim or any(a.shape[d] != n for d, n in fixed):
            raise ValueError(f"cache {path}: shape {a.shape}, expected "
                             f"{len(like.shape)} dims with "
                             f"{dict(fixed)} at these places")
        out[path] = _to_tensor(a, like.dtype, dev)
    return nest(out)


def opt_from_reference(cfg: ModelConfig, tree: Mapping, device=None):
    """The reference's optimizer state ``tree`` (numpy, as
    :func:`opt_to_reference` gives it) as the port's AdamWState or
    AdafactorState on ``device``. Raises on a missing leaf (KeyError) or
    a shape that differs (ValueError)."""
    dev = device if device is not None else get_device()
    step = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                        device=dev)
    f32 = torch.float32
    shapes = {n: tuple(p.shape) for n, p in
              model_class(cfg)(cfg, device="meta").named_parameters()}

    def leaf(a, shape, where):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{where}: shape {a.shape}, expected {shape}")
        return _to_tensor(a, f32, dev)

    if "stats" not in tree:
        moments = {}
        for name in ("m", "v"):
            flat = dict(tree_items(tree[name]))
            out = {}
            for path, names in reference_paths(cfg):
                a = flat[path]
                parts = list(a) if path.startswith("layers/") else [a]
                if len(parts) != len(names):
                    raise ValueError(f"{name}/{path}: {len(parts)} layers, "
                                     f"expected {len(names)}")
                for n, part in zip(names, parts):
                    out[n] = leaf(part, shapes[n], f"{name}/{path}")
            moments[name] = out
        return AdamWState(step=step, m=moments["m"], v=moments["v"])

    stats = {}
    for path, names in reference_paths(cfg):
        node = tree["stats"]
        for k in path.split("/"):
            node = node[k]
        shape = shapes[names[0]]
        if path.startswith("layers/"):
            shape = (len(names),) + shape
        want = ({"row": shape[:-1], "col": shape[:-2] + shape[-1:]}
                if len(shape) >= 2 else {"v": shape})
        if set(node) != set(want):
            raise KeyError(f"stats/{path}: {sorted(node)}, expected "
                           f"{sorted(want)}")
        stats[path] = {k: leaf(node[k], want[k], f"stats/{path}/{k}")
                       for k in want}
    return AdafactorState(step=step, stats=stats)
