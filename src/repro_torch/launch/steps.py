"""Train-step and serve-step builders of the port.

The JAX package's ``launch/steps.py`` on one card:

  train_step(params, opt_state, err_state, batch, generator) ->
      (params, opt_state, err_state, metrics, checksums)

``checksums`` is the ADCC hook: one f32 scalar per leaf of the
reference's trees (``params``, ``opt``, ``updates``), the sum of the new
state and of the step's applied update. Optimizer updates are additive,
so the ledger obeys ``cks_params[t] == cks_params[t-1] + cks_updates[t]``
(core/acc_state.py). A stacked layer leaf's entry is the sum of the
port's per-layer sums.

As in the reference, float32 weights are cast to the compute type
*once*, before the forward pass, and the gradient is taken with respect
to that copy. The reference casts every float32 leaf of two or more
dimensions of its *stacked* tree, so the copy casts exactly the
parameters whose leaf that is: every per-layer parameter (its stacked
leaf has one more dimension: the layers' norms, and the ssm family's
``A_log``, ``dt_bias`` and ``D_skip``, enter the forward in the compute
type) and every other parameter of two or more dimensions; the final
norm and the hybrid family's shared-block norms stay float32. The
embedding's gather backward and, for tied tables, the sum of the gather
and head gradients therefore accumulate in the compute type before the
cast back, as they do in the reference. The copy is a second model of
the same class whose parameters are refilled every step.

With ``deterministic`` (the default) the step runs under
``torch.use_deterministic_algorithms(True)``: on CUDA the embedding and
cross-entropy backward passes (``index_put_`` with accumulation) take
their sorted, atomic-free paths, and cuBLAS must be given a fixed
workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before its first
call) or torch raises. That is what makes a replay after recovery
bitwise equal to an uninterrupted run. The setting is restored after
the step; torch's filling of uninitialised memory is kept off, since
the step reads none.

``rules`` is ``None``, a mesh (``launch.mesh``: one card, or a
``DeviceMesh``) or the ``PartitionRules`` of one, and the step hands the
mesh to ``loss_fn`` as the reference's hands it its mesh: the moe
family's layers then take the expert-parallel path. Across the ranks of
a ``DeviceMesh`` (:func:`place_model` places the parameters by the
partition rules) the compute copy and the gradients are DTensors placed
as the parameters, the loss is the global mean, each gradient comes back
summed over the data axes (``layers.tp_weights``), the optimizer state
is placed as :func:`build_opt_shardings` says and updated shard by
shard, and ``grad_norm`` and the checksums are global sums.
:func:`build_serve_step` serves across ranks.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, Iterator

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from ..configs.base import TrainConfig
from ..core.acc_state import leaf_checksum
from ..models import layers as L
from ..models.carry import opt_tree, reference_paths, reference_tree, tree_items
from ..models.registry import ModelApi, family_module
from ..models.carry import param_axes
from ..optim import (AdafactorState, AdamWState, compress_decompress,
                     make_optimizer)
from ..sharding.partition import (PartitionRules, cache_shardings, make_rules,
                                  params_shardings, place, placements)
from .mesh import check_mesh, is_ranked

__all__ = ["build_train_step", "build_serve_step", "tree_checksums",
           "build_opt_shardings", "place_model", "place_opt_state",
           "train_rules"]


def tree_checksums(tree):
    """Per-leaf scalar checksums (f32 sums) of a nested dict / NamedTuple
    of tensors, same structure; a list (one stacked leaf's layers) gives
    the sum of its layers' sums. Linear in the leaf, hence incrementally
    maintainable across additive updates."""
    if isinstance(tree, dict):
        return {k: tree_checksums(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_checksums(v) for v in tree))
    return leaf_checksum(tree)


def build_opt_shardings(tcfg: TrainConfig, rules: PartitionRules,
                        params_sh, axes):
    """Optimizer-state placements (trees as ``sharding.partition.
    params_shardings`` gives them) in the reference's structure. AdamW's
    moments mirror their parameter's placements exactly; Adafactor's
    factored statistics drop the reduced logical dim (row statistics
    lose the last axis, column statistics the second to last); the step
    is replicated."""
    repl = placements(rules.mesh, ())
    if tcfg.optimizer == "adafactor":
        def stat(ax):
            if len(ax) >= 2:
                return {"row": placements(rules.mesh, rules.spec(ax[:-1])),
                        "col": placements(rules.mesh,
                                          rules.spec(ax[:-2] + ax[-1:]))}
            return {"v": placements(rules.mesh, rules.spec(ax))}

        def walk(tree):
            if isinstance(tree, dict):
                return {k: walk(v) for k, v in tree.items()}
            return stat(tree)

        return AdafactorState(step=repl, stats=walk(axes))
    return AdamWState(step=repl, m=params_sh, v=params_sh)


@contextlib.contextmanager
def deterministic_algorithms(on: bool) -> Iterator[None]:
    """``torch.use_deterministic_algorithms(on)`` for the enclosed code,
    with torch's filling of uninitialised memory off; both restored."""
    det = torch.utils.deterministic
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(on)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def _compute_copy(lm: nn.Module) -> nn.Module:
    """A model of ``lm``'s class beside it whose float32 parameters are in
    the compute type where the reference's ``to_compute`` casts their
    leaf (per-layer parameters, and others of two or more dimensions),
    every parameter a leaf that requires grad, placed as ``lm``'s (a
    DTensor as a DTensor). Values are filled by the step. The modules are
    copied with each parameter replaced by its new one (``deepcopy``'s
    memo), so no other tensor is made, not even on ``meta``."""
    cdt = L.dtype_of(lm.cfg.compute_dtype)
    memo = {}
    for name, p in lm.named_parameters():
        cast = p.dtype == torch.float32 and (name.startswith("layers.")
                                             or p.ndim >= 2)
        memo[id(p)] = nn.Parameter(torch.empty_like(
            p, dtype=cdt if cast else p.dtype).detach())
    return copy.deepcopy(lm, memo)


def place_model(lm: nn.Module, rules: PartitionRules) -> nn.Module:
    """``lm``'s parameters, global tensors that every rank holds, replaced
    in place by DTensors on ``rules.mesh`` placed by the partition rules
    (``sharding.partition.place``: each rank keeps its shard). Returns
    ``lm``."""
    for name, w in list(lm.named_parameters()):
        mod, _, attr = name.rpartition(".")
        owner = lm.get_submodule(mod) if mod else lm
        where = placements(rules.mesh, rules.spec(type(owner).AXES[attr]))
        setattr(owner, attr, nn.Parameter(
            place(w.detach(), rules.mesh, where),
            requires_grad=w.requires_grad))
    return lm


def train_rules(tcfg: TrainConfig, rules):
    """(mesh, rules) of a train step's ``rules`` argument: ``None``, a mesh
    or ``PartitionRules``. A ``DeviceMesh`` gets the reference trainer's
    ``make_rules(mesh, fsdp=tcfg.fsdp)``; without one the rules are
    None (nothing is placed)."""
    if isinstance(rules, PartitionRules):
        mesh = check_mesh(rules.mesh)
        return mesh, (rules if is_ranked(mesh) else None)
    mesh = check_mesh(rules)
    return mesh, (make_rules(mesh, fsdp=tcfg.fsdp) if is_ranked(mesh)
                  else None)


def place_opt_state(tcfg: TrainConfig, rules: PartitionRules, state,
                    lm: nn.Module):
    """Optimizer state of global tensors that every rank holds placed on
    ``rules.mesh`` as :func:`build_opt_shardings` says (the step stays
    replicated): AdamW's moments as their parameters in ``lm``, Adafactor's
    statistics by their stacked leaf's axes."""
    mesh = rules.mesh
    if isinstance(state, AdamWState):
        where = {n: p.placements for n, p in lm.named_parameters()}
        return AdamWState(
            step=state.step,
            m={n: place(t, mesh, where[n]) for n, t in state.m.items()},
            v={n: place(t, mesh, where[n]) for n, t in state.v.items()})
    sh = dict(tree_items(build_opt_shardings(
        tcfg, rules, None, param_axes(lm.cfg)).stats))
    return AdafactorState(step=state.step, stats={
        path: {k: place(t, mesh, sh[f"{path}/{k}"]) for k, t in st.items()}
        for path, st in state.stats.items()})


def _contiguous_stride(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def _stack(parts):
    """A stacked leaf's layers as one tensor; DTensors stack shard by
    shard, the leading layers dim replicated."""
    first = parts[0]
    if not isinstance(first, DTensor):
        return torch.stack(parts)
    shape = (len(parts),) + tuple(first.shape)
    return DTensor.from_local(
        torch.stack([p.to_local() for p in parts]), first.device_mesh,
        tuple(Shard(q.dim + 1) if isinstance(q, Shard) else q
              for q in first.placements), run_check=False, shape=shape,
        stride=_contiguous_stride(shape))


def _unstack(t):
    if not isinstance(t, DTensor):
        return t.unbind(0)
    where = tuple(Shard(q.dim - 1) if isinstance(q, Shard) else q
                  for q in t.placements)
    shape = tuple(t.shape[1:])
    stride = _contiguous_stride(shape)
    return [DTensor.from_local(x, t.device_mesh, where, run_check=False,
                               shape=shape, stride=stride)
            for x in t.to_local().unbind(0)]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    return tree.clone()


def build_train_step(api: ModelApi, tcfg: TrainConfig, rules=None, *,
                     donate: bool = True, batch_template=None,
                     deterministic: bool = True):
    """Returns (train_step, info, opt_init).

    ``train_step(lm, opt_state, err_state, batch, generator)`` updates the
    LM's parameters and the optimizer state in place when ``donate`` (the
    reference donates its buffers to XLA) and returns them; without
    ``donate`` it works on copies and leaves its inputs as they were.
    ``batch``: the family's batch (``launch.specs.make_batch``: tokens and
    labels; audio frames; vlm tokens, patches and M-RoPE positions) as
    tensors on the LM's device.
    ``generator`` draws the int8 compression's rounding noise (unused
    without compression). ``opt_init(lm)`` makes the optimizer state.
    ``info`` holds ``remat``, ``optimizer``, ``mesh``, ``rules`` and
    ``value_and_grad(lm, batch) -> (loss, grads)``, the step's own
    gradient path (across ranks every gradient is the global one).
    ``rules``: ``None``, a mesh or ``PartitionRules`` (see the module's
    note); across the ranks of a DeviceMesh ``lm`` is placed by
    :func:`place_model` and every rank passes the whole batch.
    ``batch_template`` pins input shardings in the reference and is
    accepted for its interface only."""
    mesh, rules = train_rules(tcfg, rules)
    cfg = api.cfg
    init_fn, opt_update = make_optimizer(tcfg)
    use_compression = tcfg.grad_compression == "int8"
    paths = reference_paths(cfg)
    # Adafactor factors and clips each *stacked* leaf as one tensor, so it
    # sees the reference's leaves; AdamW is elementwise and sees the
    # port's parameters as they are (no stacking copy)
    stacked = tcfg.optimizer == "adafactor"
    box: Dict[str, nn.Module] = {}

    def opt_view(by_name: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if not stacked:
            return by_name
        return {path: (_stack([by_name[n] for n in names])
                       if path.startswith("layers/") else by_name[names[0]])
                for path, names in paths}

    def from_view(upd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if not stacked:
            return upd
        out = {}
        for path, names in paths:
            if path.startswith("layers/"):
                out.update(zip(names, _unstack(upd[path])))
            else:
                out[names[0]] = upd[path]
        return out

    def opt_init(lm: nn.Module):
        return init_fn(opt_view(dict(lm.named_parameters())))

    def value_and_grad(lm: nn.Module, batch):
        """(loss, {parameter name: float32 gradient}) through the compute
        copy, as the step takes them."""
        params = dict(lm.named_parameters())
        cc = box.get("compute")
        if cc is None or next(cc.parameters()).device != \
                next(lm.parameters()).device:
            cc = box["compute"] = _compute_copy(lm)
        cparams = dict(cc.named_parameters())
        with torch.no_grad():
            for n, p in params.items():
                cparams[n].copy_(p)
        loss = api.loss_fn(cc, batch, mesh, remat=tcfg.remat)
        gl = torch.autograd.grad(loss, list(cparams.values()))
        return loss.detach(), {n: g.to(params[n].dtype)
                               for n, g in zip(cparams, gl)}

    def train_step(lm: nn.Module, opt_state, err_state, batch, generator):
        if not donate:
            lm, opt_state, err_state = (copy.deepcopy(lm), _clone(opt_state),
                                        _clone(err_state))
        with deterministic_algorithms(deterministic):
            loss, grads = value_and_grad(lm, batch)
            params = dict(lm.named_parameters())
            with torch.no_grad():
                if use_compression:
                    grads, err_state = compress_decompress(grads, err_state,
                                                           generator)
                upd, opt_state = opt_update(opt_view(grads), opt_state,
                                            opt_view(params))
                updates = from_view(upd)
                del upd
                for n, p in params.items():
                    p.add_(updates[n].to(p.dtype))
                sq = {n: torch.sum(torch.square(g.to(torch.float32)))
                      for n, g in grads.items()}
                del grads
                gnorm = torch.sqrt(torch.stack(
                    [leaf_checksum(x) for _, x in
                     tree_items(reference_tree(cfg, sq))]).sum())
                metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm}
                checksums = {
                    "params": tree_checksums(reference_tree(cfg, params)),
                    "opt": tree_checksums(opt_tree(cfg, opt_state)),
                    "updates": tree_checksums(reference_tree(cfg, updates)),
                }
        return lm, opt_state, err_state, metrics, checksums

    info = {"remat": tcfg.remat, "optimizer": tcfg.optimizer, "mesh": mesh,
            "rules": rules, "value_and_grad": value_and_grad}
    return train_step, info, opt_init


def build_serve_step(api: ModelApi, rules=None, *, batch: int, max_len: int,
                     donate: bool = True):
    """One-token decode step builder. Returns (serve_step, info), with
    ``serve_step(lm, cache, tokens, pos) -> (logits, cache)``: the port's
    ``decode_step``, which writes the cache in place (what the
    reference's donation of the cache amounts to); across ranks its
    logits are placed as the reference's ``out_shardings`` place them
    (``models.lm.place_logits``). ``rules``: ``None``,
    a mesh (one card, or a ``DeviceMesh`` to serve across its ranks) or
    the ``PartitionRules`` of one. ``info`` holds the cache's shapes and
    logical axes, the parameters' axes, and with a mesh the placements
    of both. Raises ValueError for an encoder (no decode step), where
    the reference's asserts."""
    if not isinstance(rules, PartitionRules):
        rules = None if check_mesh(rules) is None else make_rules(rules)
    mesh = None if rules is None else check_mesh(rules.mesh)
    cfg = api.cfg
    if api.decode_step is None:
        raise ValueError(f"{cfg.name} has no decode step")

    def serve_step(lm, cache, tokens, pos):
        return api.decode_step(lm, cache, tokens, pos, mesh)

    shapes, axes = family_module(cfg).init_cache(cfg, batch, max_len,
                                                 device="meta")
    info = {"cache_shapes": {k: tuple(v.shape) for k, v in
                             tree_items(shapes)},
            "cache_axes": axes, "axes": param_axes(cfg)}
    if rules is not None:
        info["params"] = params_shardings(rules, info["axes"])
        info["cache"] = cache_shardings(rules, axes)
    return serve_step, info
