"""Weights and optimizer state carried across between the JAX package's
trees and the port, both ways.

The reference keeps its parameters as a pytree of arrays with the layers
stacked along a leading ``n_layers`` dim:

  embed (padded_vocab, D)          norm_f (D,)      head (D, padded_vocab)
  layers/attn/{wq,wk,wv,wo}        (L, in, out)     [head absent when tied]
  layers/ffn/{w_gate,w_up,w_down}  (L, in, out)     [dense family]
  layers/norm_attn, layers/norm_ffn (L, D)

and for the moe family, in place of ``ffn``, the router and the expert
stacks ``layers/moe/{router,w_down,w_gate,w_up}`` (L, D, E) and
(L, E, in, out), with the shared experts' ``layers/shared/{w_down,
w_gate,w_up}`` (L, in, out); with MLA, ``layers/attn/{w_dkv,w_kr,w_uk,
w_uv,wo,wq}`` (L, in, out). A leaf's path is its port parameter's name
with the dots as slashes and the norms' ``.gamma`` dropped.

:func:`params_from_reference` takes that tree as nested dicts of numpy
arrays (the caller converts; nothing here imports the reference) and
loads it into an :class:`~repro_torch.models.lm.LM`. Both packages use
the ``(in, out)`` layout of ``x @ w``, so nothing is transposed.
:func:`cache_from_reference` does the same for a decode cache: GQA's
``{"k", "v"}`` of shape (L, B, max_len, KV, hd), MLA's ``{"c_kv",
"k_rope"}`` of shape (L, B, max_len, r) and (L, B, max_len, qk_rope).

The other direction, :func:`params_to_reference`, gives the port's LM as
that stacked tree of numpy arrays; :func:`opt_to_reference` and
:func:`opt_from_reference` do the same for optimizer state (AdamW
``step`` / ``m`` / ``v``, Adafactor ``step`` / ``stats``). The slots and
the checksum ledger use the reference's leaves through
:func:`reference_paths` and :func:`reference_tree`, so that a slot or a
ledger record written by either package reads in the other.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import get_device
from ..optim.adamw import AdafactorState, AdamWState
from . import layers as L
from .lm import LM, Block, init_cache

__all__ = ["params_from_reference", "cache_from_reference",
           "params_to_reference", "opt_to_reference", "opt_from_reference",
           "opt_tree", "reference_paths", "reference_tree", "nest", "tree_items",
           "to_host"]

@functools.lru_cache(maxsize=None)
def _layer_leaves(cfg: ModelConfig) -> Dict[str, str]:
    """The reference's per-layer leaves (under "layers/") -> the port's
    attribute path inside one block, read off a block on the meta
    device: "attn/wq" -> "attn.wq", "norm_ffn" -> "norm_ffn.gamma"."""
    names = [n for n, _ in Block(cfg, device="meta").named_parameters()]
    return {n.removesuffix(".gamma").replace(".", "/"): n for n in names}


def reference_paths(cfg: ModelConfig) -> List[Tuple[str, List[str]]]:
    """[(the reference's leaf path, the port's parameter names)] in the
    order ``jax.tree.leaves`` gives the reference's parameters (dict keys
    sorted). A stacked layer leaf maps to one name per layer."""
    top = {"embed": "embed", "norm_f": "norm_f.gamma"}
    if not cfg.tie_embeddings:
        top["head"] = "head"
    out = [(k, [v]) for k, v in top.items()]
    out += [(f"layers/{k}", [f"layers.{i}.{v}" for i in range(cfg.n_layers)])
            for k, v in _layer_leaves(cfg).items()]
    return sorted(out)


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


def params_to_reference(cfg: ModelConfig, lm: LM) -> Dict:
    """The LM's parameters as the reference's stacked tree of numpy
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


def params_from_reference(cfg: ModelConfig, tree: Mapping,
                          device=None) -> LM:
    """An LM on ``device`` (default :func:`repro_torch.get_device`) holding
    the reference's parameters ``tree``. Raises ValueError on a leaf the
    configuration does not have and on any shape that differs, KeyError
    on a missing leaf (as a torn slot gives)."""
    lm = LM(cfg, device=device if device is not None else get_device())
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


def cache_from_reference(cfg: ModelConfig, cache: Mapping,
                         device=None) -> Dict[str, torch.Tensor]:
    """The reference's decode cache as tensors of the compute type on
    ``device``: GQA's {"k", "v"} (L, B, max_len, KV, hd), MLA's {"c_kv"
    (L, B, max_len, r), "k_rope" (L, B, max_len, qk_rope)}."""
    dev = device if device is not None else get_device()
    dt = L.dtype_of(cfg.compute_dtype)
    want, _ = init_cache(cfg, 1, 1, device="meta")
    if sorted(cache) != sorted(want):
        raise ValueError(f"cache has {sorted(cache)}, expected "
                         f"{sorted(want)}")
    out = {}
    for name, like in want.items():
        a = np.asarray(cache[name])
        if a.ndim != like.ndim or a.shape[0] != cfg.n_layers \
                or a.shape[3:] != like.shape[3:]:
            raise ValueError(f"cache {name}: shape {a.shape} is not "
                             f"(L={cfg.n_layers}, B, max_len) + "
                             f"{tuple(like.shape[3:])}")
        out[name] = _to_tensor(a, dt, dev)
    return out


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
              LM(cfg, device="meta").named_parameters()}

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
