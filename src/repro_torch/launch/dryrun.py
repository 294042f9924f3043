"""Multi-pod dry run of the port (the JAX package's ``launch/dryrun.py``).

For every (architecture x applicable input shape) cell, on the production
meshes — (16, 16) = 256 ranks single-pod and (2, 16, 16) = 512 ranks
multi-pod — this module:

  1. brings up a ``"fake"`` process group of that world size in this
     process, as rank 0 (:func:`fake_group`: its collectives move
     nothing and return at once), and builds the ``DeviceMesh``
     (``launch.mesh.make_mesh``) and the cell's partition rules, with the
     reference's flags;
  2. builds rank 0's program on ``meta`` tensors — the model from
     ``abstract_init``, placed by ``launch.steps.place_model``; the batch
     (``launch.specs.batch_specs``) and the decode cache
     (``decode_specs``) placed by the partition rules — and runs it:
     ``build_train_step``'s step, ``api.forward`` (plain attention, as
     the reference's dry run keeps XLA's), or ``build_serve_step``'s
     step. Nothing is allocated; a shape or placement error is a
     ``FAIL`` with its traceback, as a failed lowering or compile is in
     the reference;
  3. records, for rank 0 (which holds the largest share under
     ``torch.chunk``): the bytes of its arguments, of its outputs and the
     peak of live bytes beyond the arguments while the program ran
     (:class:`LiveBytes`, the counterparts of XLA's ``memory_analysis``),
     its FLOPs (``torch.utils.flop_counter.FlopCounterMode``), the
     collectives it issued with their result bytes, keyed by the
     reference's five HLO names (:class:`Collectives`), and whether its
     arguments plus that peak fit one H100's 80 GB;
  4. writes one JSON record per cell under ``build/repro_torch/dryrun/``.

Skips are the reference's, reason for reason: decode shapes for the
encoder-only hubert; ``long_500k`` for the pure full-attention archs.

The decode step runs at position ``seq_len - 1``: its attention reads the
whole cache whatever the position, in the port as in the reference.
The error-feedback buffers of the int8 compression exist only where the
configuration compresses (the reference's step takes a float32 buffer per
parameter whatever its setting).

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import logging
import os
import time
import traceback
import weakref
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor as _FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs.base import SHAPES, ModelConfig, ShapeConfig, TrainConfig
from ..models.carry import opt_tree, reference_tree, tree_items
from ..models.registry import build_model, family_module, get_config, \
    list_archs
from ..optim import init_error_state
from ..sharding.partition import batch_shardings, make_rules, place
from .mesh import make_mesh, make_production_mesh
from .specs import batch_specs, decode_specs
from .steps import build_serve_step, build_train_step, place_model

__all__ = ["applicable_shapes", "fake_group", "LiveBytes", "Collectives",
           "Cell", "build_cell", "decode_rules", "lower_cell", "measure", "rank_leaves",
           "run_cell", "main", "ART_DIR", "H100_BYTES", "MESH_NAMES"]

# src/repro_torch/launch/dryrun.py -> the directory that holds src/
ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "build", "repro_torch", "dryrun")

# one H100's device memory, as its maker states it (80 GB)
H100_BYTES = 80 * 10 ** 9

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

MESH_NAMES = {False: "single_pod_16x16", True: "multi_pod_2x16x16"}


def applicable_shapes(cfg: ModelConfig) -> Dict[str, str]:
    """shape name -> 'run' | skip reason."""
    out = {}
    for name, shape in SHAPES.items():
        if shape.kind == "decode":
            if not cfg.is_decoder:
                out[name] = "skip: encoder-only arch has no decode step"
                continue
            if name == "long_500k" and not cfg.is_ssm_family:
                out[name] = ("skip: full-attention arch — 500k decode needs "
                             "sub-quadratic attention (DESIGN.md §4)")
                continue
        out[name] = "run"
    return out


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """A ``"fake"`` default process group of ``world`` ranks in this
    process, as rank 0 (``torch.testing``'s ``FakeStore``: collectives
    return at once and move nothing), destroyed on exit whatever
    happened. Raises RuntimeError where a process group is already live,
    which is never replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already live; the dry run "
                           "brings up its own and replaces none")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    """Bytes this rank holds of ``t`` (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.untyped_storage()


class _LocalMode(TorchDispatchMode):
    """A dispatch mode that sees the operations on plain tensors only: an
    operation on DTensors is handed back (``NotImplemented``), DTensor
    runs it, and the mode sees the local operations and collectives it
    turns into, as ``CommDebugMode`` does."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self.seen(func, args, out)
        return out

    def seen(self, func, args, out) -> None:
        raise NotImplementedError


class LiveBytes(_LocalMode):
    """Bytes of the storages on ``device`` that the enclosed operations
    create, live and at their peak. A storage is counted once, when an
    operation first returns a tensor on it, and freed when it dies (a
    weakref finalizer). Storages passed to :meth:`known` (the program's
    arguments; of a DTensor, its local tensor's) are never counted, nor
    are tensors elsewhere (host scalars, DTensor's fake tensors).

    Some of the meta device's kernels are Python code whose frames stay
    in reference cycles that hold their tensors until the cyclic garbage
    collector runs; on the card the same tensors die by their reference
    count. So every ``collect_every`` operations a full collection runs
    (the objects that lived before the program frozen out of its way;
    collecting only the young generations frees none of these): the
    peak then no longer depends on when Python chose to collect
    (phi4-mini-3.8b's ``train_4k`` rank: 831-1887 GB by the collector's
    own timing, 328 GB at any period from 16 to 1024 operations;
    hubert-xlarge's 49.3 GB at 64, 50.4 at 256; CPU)."""

    def __init__(self, device: str = "meta", collect_every: int = 256):
        super().__init__()
        self.device = torch.device(device).type
        self.collect_every = collect_every
        self.live = 0
        self.peak = 0
        self._ops = 0
        self._seen = weakref.WeakKeyDictionary()

    def __enter__(self):
        gc.collect()
        gc.freeze()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            gc.unfreeze()

    def known(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._seen[_storage(t)] = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def seen(self, func, args, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or isinstance(t, _FakeTensor) \
                    or t.device.type != self.device:
                continue
            st = _storage(t)
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.peak = max(self.peak, self.live)
        self._ops += 1
        if self.collect_every and self._ops % self.collect_every == 0:
            gc.collect()


def _bytes_of(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _collective_kinds() -> Dict[object, Tuple[str, Callable]]:
    """c10d op -> (the reference's HLO name, result bytes of its args)."""
    c10d, fn = torch.ops.c10d, torch.ops._c10d_functional
    first = lambda a: _bytes_of(a[0])                      # noqa: E731
    kinds = {
        "all-reduce": [(c10d, "allreduce_", first),
                       (fn, "all_reduce", first),
                       (fn, "all_reduce_", first)],
        "all-gather": [(c10d, "allgather_", first),
                       (c10d, "_allgather_base_", first),
                       (fn, "all_gather_into_tensor",
                        lambda a: _bytes_of(a[0]) * a[1])],
        "reduce-scatter": [(c10d, "reduce_scatter_", first),
                           (c10d, "_reduce_scatter_base_", first),
                           (fn, "reduce_scatter_tensor",
                            lambda a: _bytes_of(a[0]) // a[2])],
        "all-to-all": [(c10d, "alltoall_base_", first),
                       (c10d, "alltoall_", first),
                       (fn, "all_to_all_single", first)],
        "collective-permute": [(c10d, "send", first),
                               (c10d, "recv_", first)],
    }
    out = {}
    for name, ops in kinds.items():
        for ns, op, size in ops:
            if hasattr(ns, op):
                out[getattr(ns, op)] = (name, size)
    return out


class Collectives(_LocalMode):
    """The collectives the enclosed code issues (those DTensor issues for
    its own operations included) and their result bytes, what the
    reference parses from its HLO (an all-gather's gathered tensor, a
    reduce-scatter's scattered one), keyed by the reference's five
    names; :meth:`record` gives ``{"bytes", "counts", "total_bytes"}``."""

    def __init__(self):
        super().__init__()
        self._kinds = _collective_kinds()
        self.bytes = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}

    def seen(self, func, args, out) -> None:
        kind = self._kinds.get(func._overloadpacket)
        if kind is not None:
            name, size = kind
            self.bytes[name] += int(size(args))
            self.counts[name] += 1

    def record(self) -> Dict:
        return {"bytes": dict(self.bytes), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes.values())}


@dataclasses.dataclass
class Cell:
    """One rank's program of a cell: ``program()`` runs it, ``arguments``
    holds what it reads by group (params, opt, err, batch, cache,
    tokens)."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: object
    program: Callable
    arguments: Dict[str, object]


def _placed(tree, where, mesh):
    if isinstance(tree, dict):
        return {k: _placed(v, where[k], mesh) for k, v in tree.items()}
    return place(tree, mesh, where)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def decode_rules(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The reference dry run's decode rules: the cache's KV heads and SSM
    heads over "model" where the TP degree divides them, its sequence
    over "data" where the batch is below the data degree, attention
    heads whole (MLA's split)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    tp = sizes["model"]
    d_inner = cfg.ssm_expand * cfg.d_model
    ssm_heads = (d_inner // cfg.ssm_head_dim) if cfg.ssm_state else 0
    return make_rules(
        mesh, fsdp=False,
        kv_cache_heads_shardable=cfg.n_kv_heads > 0
        and cfg.n_kv_heads % tp == 0,
        shard_cache_seq=shape.global_batch < sizes["data"],
        shard_ssm_heads=ssm_heads > 0 and ssm_heads % tp == 0,
        replicate_attn_heads=not cfg.use_mla)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               tcfg: Optional[TrainConfig] = None, init=None,
               specs=None) -> Cell:
    """Rank's program of ``cfg`` at ``shape`` on ``mesh`` (a DeviceMesh of
    the live group), with the reference's ``lower_cell`` flags. ``init()``
    makes the model (default: ``abstract_init``, on ``meta``); ``specs``
    maps each spec tensor of the batch, the decode tokens and the cache to
    the input it stands for (default: the spec itself)."""
    api = build_model(cfg)
    lm = init() if init is not None else api.abstract_init()
    specs = specs or (lambda t: t)
    if shape.kind == "train":
        # the reference dry run's: Adafactor for kimi, AdamW otherwise
        tcfg = tcfg or TrainConfig(
            remat="dots", optimizer="adafactor"
            if cfg.name.startswith("kimi") else "adamw")
        rules = make_rules(mesh, fsdp=tcfg.fsdp)
        place_model(lm, rules)
        step, _, opt_init = build_train_step(api, tcfg, rules)
        opt = opt_init(lm)
        err = (init_error_state(dict(lm.named_parameters()))
               if tcfg.grad_compression == "int8" else {})
        batch = {k: specs(v) for k, v in batch_specs(cfg, shape).items()}
        batch = _placed(batch, batch_shardings(rules, batch), mesh)
        return Cell(cfg, shape, mesh,
                    lambda: step(lm, opt, err, batch, None),
                    {"params": lm, "opt": opt, "err": err, "batch": batch})
    if shape.kind == "prefill":
        rules = make_rules(mesh, fsdp=False)
        place_model(lm, rules)
        batch = {k: specs(v) for k, v in batch_specs(cfg, shape).items()}
        batch = _placed(batch, batch_shardings(rules, batch), mesh)
        return Cell(cfg, shape, mesh, lambda: api.forward(lm, batch, mesh),
                    {"params": lm, "batch": batch})
    rules = decode_rules(cfg, shape, mesh)
    place_model(lm, rules)
    serve_step, info = build_serve_step(api, rules, batch=shape.global_batch,
                                        max_len=shape.seq_len)
    tokens, cache, _ = decode_specs(
        cfg, shape, functools.partial(family_module(cfg).init_cache, cfg))
    cache = _placed(_map(specs, cache), info["cache"], mesh)
    tokens = specs(tokens["tokens"])
    tokens = place(tokens, mesh,
                   batch_shardings(rules, {"t": tokens})["t"])
    pos = shape.seq_len - 1
    return Cell(cfg, shape, mesh,
                lambda: serve_step(lm, cache, tokens, pos),
                {"params": lm, "cache": cache, "tokens": tokens})


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               tcfg: Optional[TrainConfig] = None) -> Tuple[Cell, object]:
    """-> (cell, mesh): rank 0's program of the cell on the production
    mesh, built and not yet run. Needs the live group of the mesh's
    world size (:func:`fake_group`)."""
    layout = make_production_mesh(multi_pod=multi_pod)
    mesh = make_mesh(layout.sizes, layout.axis_names)
    cell = build_cell(get_config(arch), SHAPES[shape_name], mesh, tcfg=tcfg)
    return cell, mesh


def _argument_items(cell: Cell) -> Dict[str, object]:
    out = {}
    for group, tree in cell.arguments.items():
        if isinstance(tree, torch.nn.Module):
            tree = dict(tree.named_parameters())
        elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
            tree = dict(tree_items(tree))
        out[group] = tree
    return out


def measure(cell: Cell) -> Dict:
    """Run the cell's program once under the counters: its memory (rank's
    bytes), FLOPs and collectives, as the record holds them."""
    from torch.utils.flop_counter import FlopCounterMode
    args = _argument_items(cell)
    arg_bytes = {g: sum(_nbytes(t) for t in tree_leaves(tree)
                        if isinstance(t, torch.Tensor))
                 for g, tree in args.items()}
    live = LiveBytes()
    live.known(args)
    flops = FlopCounterMode(display=False)
    comm = Collectives()
    with flops, comm, live:
        out = cell.program()
    if isinstance(out, tuple) and out and isinstance(out[0],
                                                     torch.nn.Module):
        out = (dict(out[0].named_parameters()),) + tuple(out[1:])
    out_bytes = sum(_nbytes(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
    total = sum(arg_bytes.values())
    return {
        "memory_analysis": {"argument_size_in_bytes": total,
                            "output_size_in_bytes": out_bytes,
                            "temp_size_in_bytes": live.peak},
        "arguments": arg_bytes,
        "cost_analysis": {"flops": float(flops.get_total_flops())},
        "collectives": comm.record(),
        "fits_h100_80gb": total + live.peak <= H100_BYTES,
    }


def _local_shape(t) -> Tuple[int, ...]:
    from torch.distributed.tensor import DTensor
    if isinstance(t, list):
        return (len(t),) + _local_shape(t[0])
    return tuple((t.to_local() if isinstance(t, DTensor) else t).shape)


def rank_leaves(cell: Cell, result=None) -> Dict[str, Dict[str,
                                                          Tuple[int, ...]]]:
    """Rank's local shape of every argument leaf, keyed by group and by
    the reference's leaf path (a stacked layer leaf (n_layers, ...)); with
    ``result``, what a prefill's or a decode step's program returned, also
    that of its logits (group "outputs", leaf "logits"), placed as the
    reference places them (``models.lm.place_logits``)."""
    cfg = cell.cfg
    out = {}
    if result is not None and cell.shape.kind != "train":
        logits = result[0] if isinstance(result, tuple) else result
        out["outputs"] = {"logits": _local_shape(logits)}
    for group, tree in cell.arguments.items():
        if group == "params":
            tree = reference_tree(cfg, dict(tree.named_parameters()))
        elif group == "opt":
            tree = opt_tree(cfg, tree)
        elif group == "tokens":
            tree = {"tokens": tree}
        out[group] = {k: _local_shape(v) for k, v in tree_items(tree)}
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, out_dir: str = ART_DIR) -> Dict:
    """The cell's record (see the module's note), written to
    ``out_dir/<arch>__<shape>__<mesh>.json`` where ``save``. The fake
    group lives only while the cell runs; where a process group is
    already live the cell raises RuntimeError (:func:`fake_group`)."""
    mesh_name = MESH_NAMES[multi_pod]
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "status": "ok"}
    cfg = get_config(arch)
    reason = applicable_shapes(cfg).get(shape_name, "run")
    if reason != "run":
        rec["status"] = reason
        if save:
            _save(rec, out_dir)
        return rec
    t0 = time.time()
    with fake_group(make_production_mesh(multi_pod=multi_pod).size):
        try:
            cell, _ = lower_cell(arch, shape_name, multi_pod)
            rec["build_seconds"] = round(time.time() - t0, 2)
            t1 = time.time()
            rec.update(measure(cell))
            rec["trace_seconds"] = round(time.time() - t1, 2)
            del cell
        except Exception as e:
            rec["status"] = f"FAIL: {type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
    if rec["status"] == "ok":
        shape = SHAPES[shape_name]
        rec["model"] = {
            "params": cfg.param_count(),
            "active_params": cfg.param_count(active_only=True),
            "tokens_per_step": shape.global_batch * (
                shape.seq_len if shape.kind != "decode" else 1),
            "kind": shape.kind,
        }
    if save:
        _save(rec, out_dir)
    return rec


def _save(rec: Dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    return path


def rank_line(rec: Dict) -> str:
    """A record's per-rank numbers: arguments + temp in GB against 80,
    FLOPs and collective bytes."""
    ma = rec["memory_analysis"]
    gb = (ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]) / 1e9
    return (f"mem={gb:.1f}/80GB{'' if rec['fits_h100_80gb'] else ' OVER'} "
            f"flops={rec['cost_analysis']['flops']:.3e} "
            f"coll={rec['collectives']['total_bytes']:.3e}B")


def _run_timed(cell: Tuple[str, str, bool], out_dir: str):
    # DTensor's advice on flattening mesh dims for faster collectives
    # concerns real ones, not a dry run's
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    t0 = time.time()
    rec = run_cell(*cell, out_dir=out_dir)
    return rec, time.time() - t0


def _report(rec: Dict, seconds: float) -> int:
    """Print a record's line (the reference's OK / SKIP / FAIL); 1 for a
    failure."""
    status = rec["status"]
    head = (f"{rec['arch']:24s} {rec['shape']:12s} "
            f"{'multi ' if rec['mesh'] == MESH_NAMES[True] else 'single'}")
    if status == "ok":
        print(f"OK   {head} {seconds:6.1f}s {rank_line(rec)}", flush=True)
    elif status.startswith("skip"):
        print(f"SKIP {head} ({status})", flush=True)
    else:
        print(f"FAIL {head} {status}", flush=True)
        return 1
    return 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run of the port")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ART_DIR,
                    help="directory of the JSON records")
    ap.add_argument("--workers", type=int, default=1,
                    help="spawned processes that run the cells, each with "
                         "fake groups of its own")
    args = ap.parse_args(argv)

    archs = list_archs() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    print("# fake process groups of 256 / 512 ranks, rank 0 traced on meta",
          flush=True)
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    t_all = time.time()
    if args.workers > 1:
        import concurrent.futures as cf
        import multiprocessing as mp
        pool = cf.ProcessPoolExecutor(args.workers,
                                      mp_context=mp.get_context("spawn"))
        # the training cells, the longest, start first; the lines come
        # in the cells' order
        kind = {"train": 0, "prefill": 1, "decode": 2}
        with pool:
            futures = {c: pool.submit(_run_timed, c, args.out) for c in
                       sorted(cells, key=lambda c: kind[SHAPES[c[1]].kind])}
            failures = sum(_report(*futures[c].result()) for c in cells)
    else:
        failures = sum(_report(*_run_timed(c, args.out)) for c in cells)
    print(f"# {time.time() - t_all:.1f} s in all", flush=True)
    print(f"done; failures={failures}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
