"""Runs of the port across ranks for the parity tests (imported by
``test_torch_sharding.py`` and by the spawned ranks; pytest collects
nothing here, and nothing here imports jax).

:func:`run_world` spawns (never forks) ``world`` processes, each of which
joins one gloo process group through a file under the caller's
directory (no port to race for), runs ``body(rank, inputs)`` and saves
what it returns. The caller waits at most ``timeout`` seconds; a rank
still running then is killed and the run raises, so that a hung
collective fails a test instead of running the suite into its limit.

:func:`sharding_body` is one rank's share of ``test_torch_sharding.py``:
every case that needs ranks, run once, its results keyed by case.
The JAX package's side of the same cases is ``mesh_reference.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
# the ranks' limit is there to fail a hung collective: alone the ranks of
# either file finish within a minute (CPU), but on a CPU shared with a
# whole test run in six workers they were seen past 120 s
TIMEOUT = 300.0
# the reference's subprocess holds no collective that can hang, but its
# compiles slow down many times over on a CPU shared with a whole test
# run: it gets a limit of its own
REF_TIMEOUT = 600.0

# the cases both packages run (the reference in mesh_reference.py)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
# (mesh, tokens) of the MoE cases; 30 tokens are padded to the mesh size
MOE_CASES = (("2x2", 64), ("1x4", 64), ("1x4", 30))
FLASH_HEADS = ((8, 2), (12, 2), (6, 1))   # (H, KV); (12, 2): G = 6
FLASH_SHAPE = (4, 16, 32)      # (B, S, hd)
FORWARD_ARCHS = ("llama3-8b", "kimi-k2-1t-a32b", "mamba2-130m",
                 "zamba2-1.2b")
FORWARD_SHAPE = (4, 16)        # (B, S)
DECODE_STEPS = 3
# the logits-placement cases of the forwards and decode steps: (mesh,
# arch, vocab), vocab None for the reduced config's 512; 501 (padded to
# 512) splits over no TP degree, and 504 splits over 2 and 4 but not in
# the padded vocabulary's blocks
LOGITS_CASES = (tuple((m, a, None) for m in MESHES for a in FORWARD_ARCHS)
                + tuple((m, "llama3-8b", v) for m in MESHES
                        for v in (501, 504)))


def logits_key(mesh: str, arch: str, vocab=None) -> str:
    return f"logits/{mesh}/{arch}" + (f"-v{vocab}" if vocab else "")


def logits_cfg(get_config, arch: str, vocab=None):
    """A logits case's configuration in either package: reduced, float32
    compute, the vocabulary ``vocab`` where given (the tables keep their
    padded width, so the reduced weights carry over)."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    return cfg if vocab is None else dataclasses.replace(cfg,
                                                         vocab_size=vocab)


PIPE_SHAPE = (8, 16, 6, 2)     # (L, D, n_micro, mb)
DRYRUN_SHAPE = (4, 16)         # (B, S) of the dry run's gloo twin


def _entry(rank: int, world: int, body: Callable, init_file: str,
           out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        torch.set_num_threads(1)
        out = body(rank, out_dir)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(body: Callable, out_dir: str, world: int = WORLD,
              timeout: float = TIMEOUT) -> List[Dict]:
    """Each rank's results of ``body`` run on ``world`` spawned gloo
    ranks (``out_dir`` holds the inputs ``body`` reads)."""
    init_file = os.path.join(out_dir, "pg_init")
    ctx = mp.start_processes(_entry, args=(world, body, init_file, out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def start_reference(out_dir, mode: str) -> subprocess.Popen:
    """``mesh_reference.py out_dir mode`` (``repro`` on its own forced
    host devices) started in a subprocess on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "mesh_reference.py"), str(out_dir),
         mode], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def wait_reference(ref: subprocess.Popen) -> None:
    """Wait for :func:`start_reference`'s subprocess within REF_TIMEOUT
    (killed then) and require its success."""
    try:
        _, err = ref.communicate(timeout=REF_TIMEOUT)
    except subprocess.TimeoutExpired:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, err[-3000:]


def load_reference(out_dir, mode: str) -> Dict:
    """What mode ``mode`` of ``mesh_reference.py`` wrote: its arrays by
    key, its ``meta`` under ``"meta"``."""
    with np.load(os.path.join(out_dir, f"{mode}.npz")) as z:
        want = {k.replace("__", "/"): z[k] for k in z.files}
    with open(os.path.join(out_dir, f"{mode}.json")) as fh:
        want["meta"] = json.load(fh)
    return want


# ---------------------------------------------------------------------------
# test_torch_sharding.py's ranks
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    """A tensor on the host; of a DTensor, this rank's local part."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.detach().to(torch.float32).numpy()


def _tree_from(flat: Dict[str, np.ndarray], prefix: str) -> Dict:
    from repro_torch.models.carry import nest
    n = len(prefix)
    return nest({k[n:]: v for k, v in flat.items() if k.startswith(prefix)})


def _f32(arch: str):
    from repro_torch.models import get_config
    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")


def _moe_module(cfg, flat):
    from repro_torch.models import moe
    m = moe.MoE(cfg, device="cpu")
    for k in ("router", "w_gate", "w_up", "w_down"):
        getattr(m, k).data.copy_(torch.from_numpy(flat[f"moe/{k}"]))
    return m


def _moe_cases(rank, meshes, flat) -> Dict:
    from repro_torch.models import moe
    from repro_torch.sharding.partition import place, placements
    cfg = _f32("kimi-k2-1t-a32b")
    m = _moe_module(cfg, flat)
    out = {}
    for name, n in MOE_CASES:
        mesh = meshes[name]
        x = torch.from_numpy(flat[f"moe/x{n}"])
        xd = place(x, mesh, placements(mesh, ("data", None)))
        t_loc = -(-n // WORLD)
        for cap, capacity in (("cfg", None),
                              ("generous", t_loc * cfg.experts_per_token)):
            moe.EP_COUNTS.update(assignments=0, dropped=0)
            y = moe.moe_apply_ep(cfg, m, xd, mesh, capacity=capacity)
            key = f"moe/{name}/{n}/{cap}"
            out[key] = _np(y.full_tensor())
            out[key + "/placements"] = tuple(map(repr, y.placements))
            out[key + "/dropped"] = int(moe.EP_COUNTS["dropped"])
    return out


def _flash_cases(meshes, flat) -> Dict:
    """Each rank passes its query heads (all KV heads) to ``flash_sdpa``;
    the heads' outputs are gathered over "model" here, in rank order."""
    from repro_torch.models import layers
    out = {}
    for name, mesh in meshes.items():
        tp, idx = mesh.size(1), mesh.get_local_rank("model")
        for H, KV in FLASH_HEADS:
            key = f"flash/{name}/{H}x{KV}"
            if key + "/q" not in flat:
                continue
            q, k, v = (torch.from_numpy(flat[f"{key}/{t}"])
                       for t in ("q", "k", "v"))
            H_loc = H // tp
            mine = layers.flash_sdpa(q[:, :, idx * H_loc:(idx + 1) * H_loc],
                                     k, v, mesh, causal=True).contiguous()
            parts = [torch.empty_like(mine) for _ in range(tp)]
            dist.all_gather(parts, mine, group=mesh.get_group("model"))
            out[key] = _np(torch.cat(parts, dim=2))
    return out


def _with_dtensor_params(lm, mesh):
    """``lm``'s parameters replaced by DTensors placed as the partition
    rules say (FSDP on "data", TP on "model")."""
    from repro_torch.launch.steps import place_model
    from repro_torch.sharding.partition import make_rules
    return place_model(lm, make_rules(mesh))


def flash_kw(cfg) -> Dict:
    """The forward's flash argument where the family has one."""
    return {} if cfg.family in ("ssm", "hybrid") else {"flash": True}


def logits_tokens(flat, arch: str, vocab=None):
    """A logits case's tokens: the arch's, below ``vocab`` where given."""
    tokens = flat[f"{arch}/tokens"]
    return tokens if vocab is None else tokens % vocab


def _forward_cases(meshes, flat) -> Dict:
    """Each logits case's prefill logits and decode steps on its mesh as
    this rank holds them (the local part of the placed DTensor) with the
    placements; on 2 x 2 with the reduced configs also the serve step's
    first step and the forward on weights placed by the rules."""
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import build_model, get_config
    from repro_torch.models.carry import params_from_reference
    out = {}
    B, S = FORWARD_SHAPE
    for name, arch, vocab in LOGITS_CASES:
        mesh = meshes[name]
        key = logits_key(name, arch, vocab)
        cfg = logits_cfg(get_config, arch, vocab)
        api = build_model(cfg)
        tree = _tree_from(flat, f"{arch}/params/")
        lm = params_from_reference(cfg, tree, device="cpu")
        tokens = torch.from_numpy(logits_tokens(flat, arch, vocab))
        logits = api.forward(lm, {"tokens": tokens}, mesh, **flash_kw(cfg))
        out[f"{key}/forward"] = _np(logits)
        out[f"{key}/placements"] = tuple(map(repr, logits.placements))
        cache, _ = api.init_cache(B, DECODE_STEPS + 1)
        steps = []
        for t in range(DECODE_STEPS):
            logits, cache = api.decode_step(lm, cache, tokens[:, t:t + 1], t,
                                            mesh)
            steps.append(_np(logits))
        out[f"{key}/decode"] = np.stack(steps)
        out[f"{key}/decode_placements"] = tuple(map(repr, logits.placements))
        if name != "2x2" or vocab is not None:
            continue
        serve_step, info = build_serve_step(api, mesh, batch=B,
                                            max_len=DECODE_STEPS + 1)
        logits, _ = serve_step(lm, api.init_cache(B, DECODE_STEPS + 1)[0],
                               tokens[:, :1], 0)
        out[f"{key}/serve_step"] = _np(logits)
        out[f"{key}/serve_info"] = sorted(info)
        placed = _with_dtensor_params(
            params_from_reference(cfg, tree, device="cpu"), mesh)
        out[f"{key}/forward_dtensor"] = _np(api.forward(
            placed, {"tokens": tokens}, mesh, **flash_kw(cfg)))
    return out


def _training_cases(mesh, flat) -> Dict:
    """llama3-8b's loss across the ranks of ``mesh``: ``api.loss_fn`` on
    placed weights, and the loss of ``build_train_step``'s first step."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.models.carry import params_from_reference
    cfg = _f32("llama3-8b")
    api = build_model(cfg)
    tokens = torch.from_numpy(flat["llama3-8b/tokens"])
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    lm = _with_dtensor_params(params_from_reference(
        cfg, _tree_from(flat, "llama3-8b/params/"), device="cpu"), mesh)
    loss = float(api.loss_fn(lm, batch, mesh))
    step, info, opt_init = build_train_step(api, TrainConfig(), mesh)
    _, _, _, metrics, _ = step(lm, opt_init(lm), {}, batch, None)
    return {"train/loss_fn": loss, "train/step_loss": float(metrics["loss"]),
            "train/mesh_is_kept": info["mesh"] is mesh}


def _c1_cases(meshes, flat) -> Dict:
    """What a tensor-parallel layer materialises: the expert stacks
    ``ep_body`` receives (reduced deepseek on 1 x 4); the bytes one
    llama3-8b layer all-gathers on 2 x 2 (``CommDebugMode``, the output
    of each ``all_gather_into_tensor``), beside the FSDP gather of each
    weight's TP-only placement; and any ``full_tensor`` of a parameter
    in a placed forward."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.steps import place_model
    from repro_torch.models import build_model, get_config, layers, moe
    from repro_torch.sharding.partition import make_rules, tp_dim

    out = {}
    seen = []
    body = moe.ep_body

    def spy(cfg, p, *a, **k):
        seen.append(tuple(p.w_gate.shape))
        return body(cfg, p, *a, **k)

    full = DTensor.full_tensor
    whole = []

    def read_whole(self, *a, **k):
        if isinstance(self, torch.nn.Parameter):
            whole.append(tuple(self.shape))
        return full(self, *a, **k)

    cfg = _f32("deepseek-v2-lite-16b")
    api = build_model(cfg)
    mesh = meshes["1x4"]
    lm = place_model(api.init(torch.Generator().manual_seed(0)),
                     make_rules(mesh))
    moe.ep_body, DTensor.full_tensor = spy, read_whole
    try:
        api.forward(lm, {"tokens": torch.zeros((4, 16), dtype=torch.int64)},
                    mesh)
        llama = _f32("llama3-8b")
        mesh = meshes["2x2"]
        lm = place_model(build_model(llama).init(
            torch.Generator().manual_seed(0)), make_rules(mesh))
        build_model(llama).forward(
            lm, {"tokens": torch.from_numpy(flat["llama3-8b/tokens"])}, mesh)
    finally:
        moe.ep_body, DTensor.full_tensor = body, full
    out["c1/ep_stacks"] = seen
    out["c1/deepseek_dims"] = (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    out["c1/whole_reads"] = whole

    class GatherBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.gathered = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket == \
                    torch.ops._c10d_functional.all_gather_into_tensor:
                self.gathered += (args[0].numel() * args[0].element_size()
                                  * args[1])
            return super().__torch_dispatch__(func, types, args, kwargs)

    layer = lm.layers[0]
    with GatherBytes() as count, layers.tp_weights(layer, mesh):
        pass
    tp = mesh.size(1)
    expect = whole_bytes = 0
    for name, w in layer.named_parameters():
        owner = layer.get_submodule(name.rpartition(".")[0])
        ax = type(owner).AXES[name.rpartition(".")[2]]
        split = tp_dim(tuple(w.shape), ax, tp) is not None and (
            owner.splits(tp) if hasattr(owner, "splits") else True)
        expect += w.numel() * w.element_size() // (tp if split else 1)
        whole_bytes += w.numel() * w.element_size()
    out["c1/gathered"] = count.gathered
    out["c1/expected"] = expect
    out["c1/whole"] = whole_bytes
    return out


def _pipeline_cases(flat) -> Dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.pipeline import pipeline_apply, stage_params
    W = torch.from_numpy(flat["pipe/W"])
    x = torch.from_numpy(flat["pipe/x"])

    def stage_fn(p, act):
        for w in p:
            act = torch.tanh(act @ w)
        return act

    four = make_mesh((WORLD,), ("stage",))
    one = make_mesh((WORLD, 1), ("data", "stage"))
    return {"pipe/four": _np(pipeline_apply(stage_fn, stage_params(W, WORLD),
                                            x, four)),
            "pipe/one": _np(pipeline_apply(stage_fn, stage_params(W, 1), x,
                                           one))}


def _shard_act_cases(mesh) -> Dict:
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import layers
    from repro_torch.sharding.partition import place
    rep = (Replicate(), Replicate())
    x = place(torch.arange(4 * 8 * 16.).reshape(4, 8, 16), mesh, rep)
    y = layers.shard_act(x, mesh)
    one = place(torch.ones(1, 8, 16), mesh, rep)
    plain = torch.ones(4, 8, 16)
    w = place(torch.arange(8 * 16.).reshape(8, 16), mesh,
              (Shard(0), Shard(1)))
    g = layers.gather_weights({"w": w}, {"w": ("embed", "mlp")}, mesh)["w"]
    return {"shard_act/placements": tuple(map(repr, y.placements)),
            "shard_act/local_shape": tuple(y.to_local().shape),
            "shard_act/values": _np(y.full_tensor()),
            "shard_act/batch1": tuple(map(repr, layers.shard_act(
                one, mesh).placements)),
            "shard_act/plain_is_same": layers.shard_act(plain, mesh) is plain,
            "gather/placements": tuple(map(repr, g.placements)),
            "gather/values": _np(g.full_tensor())}


def _restore_cases(mesh, out_dir) -> Dict:
    from repro_torch.checkpoint.manager import restore_elastic
    from repro_torch.models.carry import param_axes, tree_items
    from repro_torch.sharding.partition import make_rules, params_shardings
    cfg = _f32("llama3-8b")
    axes = param_axes(cfg)
    rules = make_rules(mesh)
    want = dict(tree_items(params_shardings(rules, axes)))
    out = {}
    for writer in ("port", "repro"):
        path = os.path.join(out_dir, f"ckpt_{writer}")
        with np.load(os.path.join(path, "state.npz")) as z:
            template = {k.replace("__", "/"): torch.zeros(z[k].shape)
                        for k in z.files}
        from repro_torch.models.carry import nest
        state, meta = restore_elastic(path, nest(template), rules, axes)
        for k, t in tree_items(state):
            out[f"restore/{writer}/{k}"] = t.full_tensor().numpy()
            assert tuple(t.placements) == tuple(want[k]), k
        out[f"restore/{writer}/step"] = meta["step"]
    return out


# the placed-leaf cases: (arch, decode batch); a batch of 1 puts the
# cache's positions over "data", as the dry run's long_500k does
PLACED_CASES = (("llama3-8b", 4), ("zamba2-1.2b", 4), ("zamba2-1.2b", 1))


def _placed_cases(mesh, flat) -> Dict:
    """Batch and cache leaves placed by the partition rules, as the dry
    run places them, against the same steps on leaves every rank holds
    whole: the prefill forward of a placed token batch, and decode steps
    on a cache placed by ``dryrun.decode_rules`` (KV and SSM heads over
    "model", and for a batch of 1 the positions over "data") with the
    weights placed by the same rules."""
    import copy

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_serve_step, place_model
    from repro_torch.models import build_model
    from repro_torch.models.carry import tree_items
    from repro_torch.sharding.partition import (batch_shardings, make_rules,
                                                place)
    out = {}
    L = DECODE_STEPS + 1
    for arch, B in PLACED_CASES:
        cfg = _f32(arch)
        api = build_model(cfg)
        lm = api.init(torch.Generator().manual_seed(3))
        tokens = torch.from_numpy(flat[f"{arch}/tokens"])[:B]
        key = f"placed/{arch}/{B}"
        if B == FORWARD_SHAPE[0]:
            batch = {"tokens": tokens}
            where = batch_shardings(make_rules(mesh), batch)["tokens"]
            out[key + "/forward_whole"] = _np(api.forward(lm, batch, mesh))
            out[key + "/forward_placed"] = _np(api.forward(
                lm, {"tokens": place(tokens, mesh, where)}, mesh))
        cache, _ = api.init_cache(B, L)
        whole = []
        for t in range(DECODE_STEPS):
            logits, cache = api.decode_step(lm, cache, tokens[:, t:t + 1],
                                            t, mesh)
            whole.append(_np(logits))
        rules = dryrun.decode_rules(cfg, ShapeConfig("t", L, B, "decode"),
                                    mesh)
        placed_lm = place_model(copy.deepcopy(lm), rules)
        step, info = build_serve_step(api, rules, batch=B, max_len=L)
        cache = dryrun._placed(api.init_cache(B, L)[0], info["cache"], mesh)
        out[key + "/cache_local"] = {
            k: tuple(v.to_local().shape) for k, v in tree_items(cache)}
        tok_where = batch_shardings(rules, {"t": tokens})["t"]
        placed = []
        for t in range(DECODE_STEPS):
            logits, cache = step(placed_lm, cache, place(
                tokens[:, t:t + 1].contiguous(), mesh, tok_where), t)
            placed.append(_np(logits))
        out[key + "/decode_whole"] = np.stack(whole)
        out[key + "/decode_placed"] = np.stack(placed)
    return out


def _dryrun_cases(mesh) -> Dict:
    """The dry run's program of reduced llama3-8b's prefill (``dryrun.
    build_cell``) run for real on this rank: the collectives
    ``dryrun.Collectives`` records, beside the number ``CommDebugMode``
    counts."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model, get_config
    cfg = get_config("llama3-8b").reduced()
    api = build_model(cfg)
    B, S = DRYRUN_SHAPE
    cell = dryrun.build_cell(
        cfg, ShapeConfig("t", S, B, "prefill"), mesh,
        init=lambda: api.init(torch.Generator().manual_seed(4)),
        specs=lambda t: torch.zeros(t.shape, dtype=t.dtype))
    with CommDebugMode() as cdm, dryrun.Collectives() as col:
        cell.program()
    return {"dryrun/collectives": col.record(),
            "dryrun/comm_debug_total": cdm.get_total_counts()}


def sharding_body(rank: int, out_dir: str) -> Dict:
    """Every case of ``test_torch_sharding.py`` that needs ranks."""
    import repro_torch
    from repro_torch.launch.mesh import make_mesh
    with np.load(os.path.join(out_dir, "inputs.npz")) as z:
        flat = {k.replace("__", "/"): z[k] for k in z.files}
    out = {}
    with repro_torch.use_device("cpu"):
        meshes = {name: make_mesh(shape, axes)
                  for name, (shape, axes) in MESHES.items()}
        out.update(_moe_cases(rank, meshes, flat))
        out.update(_flash_cases(meshes, flat))
        out.update(_forward_cases(meshes, flat))
        out.update(_training_cases(meshes["2x2"], flat))
        out.update(_c1_cases(meshes, flat))
        out.update(_pipeline_cases(flat))
        out.update(_shard_act_cases(meshes["2x2"]))
        out.update(_restore_cases(meshes["2x2"], out_dir))
        out.update(_placed_cases(meshes["2x2"], flat))
        out.update(_dryrun_cases(meshes["2x2"]))
    return out


# ---------------------------------------------------------------------------
# test_torch_train_ranks.py's ranks
# ---------------------------------------------------------------------------

# (arch, mesh, optimizer) of the train-step twins, and their shape
TRAIN_CASES = (("llama3-8b", "2x2", "adamw"),
               ("deepseek-v2-lite-16b", "1x4", "adamw"),
               ("mamba2-130m", "2x2", "adafactor"))
TRAIN_SHAPE = (4, 16)          # (B, S)
TRAIN_STEPS = 3
# the gradient twins with the vocabulary split unevenly over "model":
# reduced llama3-8b at a vocabulary of 501 (padded to 512) at TP 2 and 4,
# its labels with -100s; (mesh, vocab)
VOCAB_CASES = (("2x2", 501), ("1x4", 501))


def vocab_case(mesh: str, vocab: int) -> str:
    return f"llama3-8b-v{vocab}-{mesh}"
# the trainer's runs: llama3-8b reduced, as tests/test_torch_train.py's
TRAINER = dict(batch=4, seq=32, slot_every=2)
TRAINER_STEPS, CRASH_AT, REF_SLOT_STEP = 8, 6, 2


def train_cfg(get_config, arch: str):
    """The twins' configuration of ``arch`` in either package: reduced,
    float32 compute; deepseek with every expert selected (no float32
    difference can then change a token's experts, as in
    tests/test_torch_moe.py) and capacity factor 0.5, so that each
    destination keeps the first half of what it is sent and the EP path
    drops assignments, the same ones in both packages (its capacity
    falls between two tokens' assignments)."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, experts_per_token=cfg.n_experts,
                                  capacity_factor=0.5)
    return cfg


def train_tcfg(TrainConfig, optimizer: str, **kw):
    return TrainConfig(remat="dots", warmup_steps=2, total_steps=20,
                       optimizer=optimizer, **kw)


def _stacked_placements(x):
    """A leaf's placements as the reference's stacked leaf has them: a
    list of layers (AdamW's moments) shifts each Shard dim by the layers
    dim, and every layer must agree."""
    from torch.distributed.tensor import Shard
    if not isinstance(x, list):
        return tuple(x.placements)
    where = {tuple(Shard(q.dim + 1) if isinstance(q, Shard) else q
                   for q in t.placements) for t in x}
    assert len(where) == 1, where
    return where.pop()


def _flat_checksums(c) -> Dict:
    from repro_torch.core.acc_state import flatten_checksums
    return {k: flatten_checksums(c[k]) for k in ("params", "opt", "updates")}


def _steps(arch, mesh, optimizer, flat, compression="none") -> Dict:
    """TRAIN_STEPS steps of ``build_train_step`` on ``mesh`` (None: one
    card) from the carried weights: per step the loss, grad_norm and
    flat checksums; the parameters after them, and the placements of the
    optimizer state beside ``build_opt_shardings``'."""
    from repro_torch.models import get_config
    return _steps_of(train_cfg(get_config, arch), mesh, optimizer, flat,
                     arch, compression)


def _steps_of(cfg, mesh, optimizer, flat, src,
              compression="none") -> Dict:
    """:func:`_steps` of ``cfg``, its weights and batches under ``src/``
    in ``flat``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import (build_opt_shardings,
                                          build_train_step, place_model)
    from repro_torch.models import build_model
    from repro_torch.models.carry import (opt_tree, param_axes,
                                          params_from_reference,
                                          params_to_reference, tree_items)
    from repro_torch.optim import init_error_state
    from repro_torch.sharding.partition import (make_rules,
                                                params_shardings)
    tcfg = train_tcfg(TrainConfig, optimizer, grad_compression=compression)
    lm = params_from_reference(cfg, _tree_from(flat, f"{src}/params/"),
                               device="cpu")
    if mesh is not None:
        lm = place_model(lm, make_rules(mesh))
    step, info, opt_init = build_train_step(build_model(cfg), tcfg, mesh)
    opt = opt_init(lm)
    out = {}
    if mesh is not None:
        axes = param_axes(cfg)
        want = build_opt_shardings(tcfg, info["rules"], params_shardings(
            info["rules"], axes), axes)
        out["opt_placements"] = [
            (p, _stacked_placements(x))
            for p, x in tree_items(opt_tree(cfg, opt)) if p != "step"]
        out["opt_want"] = [
            (p, tuple(w)) for p, w in tree_items(want) if p != "step"]
    err = (init_error_state(dict(lm.named_parameters()))
           if compression != "none" else {})
    for t in range(TRAIN_STEPS):
        batch = _batch(flat, f"{src}/batch{t}/")
        lm, opt, err, m, c = step(lm, opt, err, batch,
                                  torch.Generator().manual_seed(t))
        out[f"{t}/loss"] = float(m["loss"])
        out[f"{t}/grad_norm"] = float(m["grad_norm"])
        out[f"{t}/checksums"] = _flat_checksums(c)
    out["params"] = dict(tree_items(params_to_reference(cfg, lm)))
    return out


def _wide(fn, width: int):
    """(``fn()``, the shapes of the tensors on the CPU that the local
    operations of ``fn`` make whose last dim is ``width``), the backward
    included; DTensor's shape propagation on ``meta`` allocates nothing
    and is not counted."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._pytree import tree_leaves

    from repro_torch.launch.dryrun import _LocalMode
    shapes = []

    class Spy(_LocalMode):
        def seen(self, func, args, out):
            shapes.extend(tuple(t.shape) for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor)
                          and not isinstance(t, FakeTensor)
                          and t.device.type == "cpu" and t.dim()
                          and t.shape[-1] == width)

    with Spy():
        out = fn()
    return out, shapes


def _batch(flat, prefix: str) -> Dict:
    """The batch whose leaves ``flat`` holds under ``prefix``."""
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in flat.items()
            if k.startswith(prefix)}


def _grads(arch, mesh, flat, vocab=None) -> Dict:
    """The step's ``value_and_grad`` across the ranks: the loss and every
    leaf's global gradient in the reference's layout, and the shapes of
    the tensors of the padded vocabulary's width that the loss and its
    backward made on the rank. ``vocab``: the configuration's vocabulary
    and batch of ``VOCAB_CASES``."""
    from repro_torch.models import get_config
    cfg = train_cfg(get_config, arch)
    if vocab is not None:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return _grads_of(cfg, mesh, flat, arch,
                     f"{arch if vocab is None else f'v{vocab}'}/batch0/")


def _grads_of(cfg, mesh, flat, src: str, batch: str) -> Dict:
    """:func:`_grads` of ``cfg``, its weights under ``src/params/`` in
    ``flat`` and its batch under ``batch``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import build_train_step, place_model
    from repro_torch.models import build_model
    from repro_torch.models.carry import (params_from_reference,
                                          reference_tree, to_host,
                                          tree_items)
    from repro_torch.sharding.partition import make_rules
    lm = place_model(params_from_reference(
        cfg, _tree_from(flat, f"{src}/params/"), device="cpu"),
        make_rules(mesh))
    _, info, _ = build_train_step(build_model(cfg),
                                  TrainConfig(remat="none"), mesh)
    (loss, grads), wide = _wide(
        lambda: info["value_and_grad"](lm, _batch(flat, batch)),
        cfg.padded_vocab)
    return {"loss": float(loss), "wide": wide,
            "grads": {p: to_host(x) for p, x in
                      tree_items(reference_tree(cfg, grads))}}


def _vocab_ce_cases(mesh) -> Dict:
    """``lm.vocab_parallel_nll`` on this rank's block of random logits of
    a vocabulary of 501 padded to 512, labels with -100s (one at rank 0's
    column 0's row), with the padded columns 0 and 1e4: the mean and the
    block's gradient of each, and of ``lm._nll_terms`` on the whole
    vocabulary's logits the same."""
    from repro_torch.models import lm as lm_mod
    tp, idx = mesh.size(1), mesh.get_local_rank("model")
    V, P = 501, 512
    p = P // tp
    g = torch.Generator().manual_seed(5)
    whole = torch.randn(2, 8, P, generator=g) * 3.0
    labels = torch.randint(0, V, (2, 8), generator=g)
    labels[0, :3] = -100
    labels[1, 0], labels[1, 1], labels[1, 7] = 0, V - 1, -100
    out = {"ce/labels": labels.numpy()}
    for junk in (0.0, 1e4):
        x = whole.clone()
        x[..., V:] = junk
        block = x[..., idx * p:(idx + 1) * p].clone().requires_grad_(True)
        num, cnt = lm_mod.vocab_parallel_nll(block, labels, V, mesh)
        loss = num / cnt
        loss.backward()
        out[f"ce/{junk}/loss"] = float(loss)
        out[f"ce/{junk}/grad"] = _np(block.grad)
    ref = whole[..., :V].clone().requires_grad_(True)
    num, cnt = lm_mod._nll_terms(ref, labels)
    (num / cnt).backward()
    grad = torch.cat([ref.grad, torch.zeros(2, 8, P - V)], dim=-1)
    out["ce/ref/loss"] = float(num / cnt)
    out["ce/ref/grad"] = _np(grad[..., idx * p:(idx + 1) * p])
    out["ce/lo"] = idx * p
    return out


def _trainer(workdir, mesh, mode="adcc"):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import ADCCTrainer
    from repro_torch.models import get_config
    cfg = get_config("llama3-8b").reduced()
    tcfg = TrainConfig(remat="none", total_steps=40, warmup_steps=5)
    return ADCCTrainer(cfg, tcfg, workdir, mesh=mesh, mode=mode, **TRAINER)


def _final(tr) -> Dict:
    from repro_torch.models.carry import params_to_reference, tree_items
    return dict(tree_items(params_to_reference(tr.cfg, tr._final_params)))


def _trainer_cases(rank, mesh, out_dir) -> Dict:
    """The ADCC trainer on ``mesh``: an uninterrupted run; a run that
    crashes, whose newest slot rank 0 then tears, and its restart; sync
    mode's crash and restart; a restart from a slot that ``repro``
    wrote."""
    from repro_torch.core.slots import SlotStore
    from repro_torch.models.carry import params_to_reference, tree_items
    out = {}
    whole = _trainer(os.path.join(out_dir, "whole"), mesh)
    r = whole.run(TRAINER_STEPS, log_every=0)
    out["whole/losses"], out["whole/final"] = r.losses, _final(whole)

    wd = os.path.join(out_dir, "crash")
    _trainer(wd, mesh).run(TRAINER_STEPS, crash_at_step=CRASH_AT,
                           log_every=0)
    store = SlotStore(os.path.join(wd, "slots"), whole.store.n_slots)
    newest_slot, newest_step = store.slots_by_recency()[0]
    if rank == 0:     # tear the newest slot's first tensor
        d = store.slot_dir(newest_slot)
        fn = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
        np.save(os.path.join(d, fn), np.load(os.path.join(d, fn)) + 1000.0)
    dist.barrier()
    again = _trainer(wd, mesh)
    r2 = again.run(TRAINER_STEPS, log_every=0)
    out.update({"crash/newest": newest_step,
                "crash/resumed_from": r2.resumed_from,
                "crash/checks": again.recovery_checks,
                "crash/losses": r2.losses, "crash/final": _final(again)})

    wd = os.path.join(out_dir, "sync")
    _trainer(wd, mesh, "sync").run(TRAINER_STEPS, crash_at_step=CRASH_AT,
                                   log_every=0)
    out["sync/resumed_from"] = _trainer(wd, mesh, "sync").run(
        TRAINER_STEPS, log_every=0).resumed_from

    tr = _trainer(os.path.join(out_dir, "repro"), mesh)
    seen = {}
    step_fn = tr.step_fn

    def spy(lm, *a):
        if "p" not in seen:
            seen["p"] = dict(tree_items(params_to_reference(tr.cfg, lm)))
        return step_fn(lm, *a)

    tr.step_fn = spy
    r3 = tr.run(REF_SLOT_STEP + 2, log_every=0)
    out.update({"repro/resumed_from": r3.resumed_from,
                "repro/report": r3.recovery_report,
                "repro/params": seen["p"]})
    return out


def train_body(rank: int, out_dir: str) -> Dict:
    """Every case of ``test_torch_train_ranks.py`` that needs ranks."""
    import repro_torch
    from repro_torch.launch.mesh import make_mesh
    with np.load(os.path.join(out_dir, "inputs.npz")) as z:
        flat = {k.replace("__", "/"): z[k] for k in z.files}
    out = {}
    with repro_torch.use_device("cpu"):
        meshes = {name: make_mesh(shape, axes)
                  for name, (shape, axes) in MESHES.items()}
        for arch, mesh, optimizer in TRAIN_CASES:
            out[f"grads/{arch}"] = _grads(arch, meshes[mesh], flat)
            out[f"steps/{arch}"] = _steps(arch, meshes[mesh], optimizer,
                                          flat)
        for mesh, vocab in VOCAB_CASES:
            out[f"grads/{vocab_case(mesh, vocab)}"] = _grads(
                "llama3-8b", meshes[mesh], flat, vocab)
        out.update(_vocab_ce_cases(meshes["1x4"]))
        out["int8"] = _steps("llama3-8b", meshes["2x2"], "adamw", flat,
                             compression="int8")
        out.update(_trainer_cases(rank, meshes["2x2"], out_dir))
    return out


# ---------------------------------------------------------------------------
# test_torch_head_groups.py's ranks
# ---------------------------------------------------------------------------

# reduced configs whose query heads a TP degree of 4 does not tile, as
# phi4-mini-3.8b's 24 (KV 8) and qwen2-vl-2b's 12 (KV 2) at 16: (name,
# arch, H, KV). At 1 x 4 each is 2 blocks of 3 heads, 2 ranks a block
# (dense: one KV group a block; vlm: half of the one group); at 2 x 2
# the heads tile, and each rank is a block of its own
HEAD_CASES = (("dense", "phi4-mini-3.8b", 6, 2), ("vlm", "qwen2-vl-2b", 6, 1))
# a block of 3 heads over 1.5 KV groups (no arch): the forward at 1 x 4
HEAD_KV3 = ("kv3", "phi4-mini-3.8b", 6, 3)
HEAD_SHAPE = (4, 24)           # (B, S); the vlm's S: 16 patches, 8 tokens
# the pin at 1 x 16, phi4-mini-3.8b's and qwen2-vl-2b's heads: (name,
# arch, H, KV), one narrow layer each
HEAD_WIDE = (("phi4", "phi4-mini-3.8b", 24, 8),
             ("qwen2vl", "qwen2-vl-2b", 12, 2))
HEAD_WIDE_TP = 16
# the K/V pin (C6): HEAD_WIDE and a llama3-8b-like 32 over 8 at 1 x 16
# (one narrow layer each), and reduced llama3-8b (4 over 2) on 2 x 2, the
# dry run's hand-formula case
KV_WIDE = HEAD_WIDE + (("llama", "llama3-8b", 32, 8),)
KV_LLAMA = ("llama", "llama3-8b", 4, 2)
KV_LLAMA_MESH = "2x2"
# the decode pin's own case (C7): zamba2-1.2b's shared-attention heads, 32
# over 32, at 1 x 16 (one narrow layer), whose cache the decode rules
# split by heads: 2 a rank
KV_DECODE = ("kv32", "llama3-8b", 32, 32)


def head_cfg(get_config, arch: str, H: int, KV: int):
    """A head-group case's configuration in either package: ``arch``
    reduced, with ``H`` / ``KV`` heads, float32 compute."""
    return dataclasses.replace(get_config(arch).reduced(), n_heads=H,
                               n_kv_heads=KV, compute_dtype="float32")


def wide_cfg(get_config, arch: str, H: int, KV: int):
    """A 1 x 16 pin's configuration: one layer of width 64, head dim 32."""
    return dataclasses.replace(head_cfg(get_config, arch, H, KV),
                               n_layers=1, d_model=64)


@contextlib.contextmanager
def scored_heads():
    """The query heads of each attention score that ``layers._sdpa``
    computes while the enclosed code runs, but a decode step's (a list
    that fills)."""
    from repro_torch.models import layers
    seen = []
    sdpa = layers._sdpa

    def spy(q, k, v, **kw):
        if kw.get("kv_len") is None:
            seen.append(int(q.shape[2]))
        return sdpa(q, k, v, **kw)

    layers._sdpa = spy
    try:
        yield seen
    finally:
        layers._sdpa = sdpa


@contextlib.contextmanager
def kv_columns(decode: bool = False):
    """The columns of the K and V projections of each prefill or train
    step call of ``layers.attention_body`` while the enclosed code runs
    (of each decode step call where ``decode``): the products of its
    input ``x`` (q, k, v in that order) but the first, a list of (k, v)
    that fills."""
    from torch.overrides import TorchFunctionMode
    from repro_torch.models import layers
    seen = []
    body = layers.attention_body

    class Products(TorchFunctionMode):
        def __init__(self, x):
            super().__init__()
            self.x, self.cols = x, []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if getattr(func, "__name__", "") == "matmul" and args[0] is self.x:
                self.cols.append(int(out.shape[-1]))
            return out

    def spy(cfg, p, x, *a, **kw):
        with Products(x) as products:
            out = body(cfg, p, x, *a, **kw)
        if (kw.get("cache") is not None) == decode:
            seen.append(tuple(products.cols[1:]))
        return out

    layers.attention_body = spy
    try:
        yield seen
    finally:
        layers.attention_body = body


@contextlib.contextmanager
def whole_reads():
    """The shapes of the parameters read through ``DTensor.full_tensor``
    while the enclosed code runs (a list that fills)."""
    from torch.distributed.tensor import DTensor
    seen = []
    full = DTensor.full_tensor

    def spy(self, *a, **k):
        if isinstance(self, torch.nn.Parameter):
            seen.append(tuple(self.shape))
        return full(self, *a, **k)

    DTensor.full_tensor = spy
    try:
        yield seen
    finally:
        DTensor.full_tensor = full


def _head_forward(cfg, mesh, flat, src: str) -> Dict:
    """The forward and DECODE_STEPS decode steps of ``cfg`` on ``mesh``
    (weights and batch under ``src/`` in ``flat``) as this rank holds
    their logits, with the heads each of its scores held and the columns
    of each K/V projection of the forward."""
    from repro_torch.models import build_model
    from repro_torch.models.carry import params_from_reference
    api = build_model(cfg)
    lm = params_from_reference(cfg, _tree_from(flat, f"{src}/params/"),
                               device="cpu")
    batch = _batch(flat, f"{src}/batch0/")
    batch.pop("labels")
    with scored_heads() as heads, kv_columns() as kv:
        logits = api.forward(lm, batch, mesh)
    out = {"forward": _np(logits), "heads": heads, "kv": kv,
           "placements": tuple(map(repr, logits.placements))}
    B = HEAD_SHAPE[0]
    cache, _ = api.init_cache(B, DECODE_STEPS + 1)
    steps = []
    for t in range(DECODE_STEPS):
        logits, cache = api.decode_step(
            lm, cache, batch["tokens"][:, t:t + 1], t, mesh)
        steps.append(_np(logits))
    out["decode"] = np.stack(steps)
    return out


def kv_decode(cfg, mesh) -> list:
    """The columns of each K/V projection of one decode step of ``cfg``
    (weights from seed 0, HEAD_SHAPE's batch) through
    ``build_serve_step`` on ``mesh`` under the dry run's decode rules
    (``dryrun.decode_rules``: the cache's KV heads over "model" where the
    TP degree divides them), its weights and cache placed by them."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_serve_step, place_model
    from repro_torch.models import build_model
    from repro_torch.sharding.partition import batch_shardings, place
    api = build_model(cfg)
    B, L = HEAD_SHAPE[0], DECODE_STEPS + 1
    rules = dryrun.decode_rules(cfg, ShapeConfig("t", L, B, "decode"), mesh)
    lm = place_model(api.init(torch.Generator().manual_seed(0)), rules)
    step, info = build_serve_step(api, rules, batch=B, max_len=L)
    cache = dryrun._placed(api.init_cache(B, L)[0], info["cache"], mesh)
    tokens = torch.zeros((B, 1), dtype=torch.int32)
    tokens = place(tokens, mesh, batch_shardings(rules, {"t": tokens})["t"])
    with torch.no_grad(), kv_columns(decode=True) as kv:
        step(lm, cache, tokens, 0)
    return kv


def kv_case(cfg, mesh) -> Dict:
    """``cfg``'s forward and gradient on ``mesh`` (weights and batch from
    seeds 0 and 1, HEAD_SHAPE): the heads of each score of the forward
    and the columns of each K/V projection of both, and of a decode step
    (:func:`kv_decode`)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.specs import make_batch
    from repro_torch.launch.steps import build_train_step, place_model
    from repro_torch.models import build_model
    from repro_torch.sharding.partition import make_rules
    api = build_model(cfg)
    lm = api.init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, *HEAD_SHAPE, torch.Generator().manual_seed(1))
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad(), scored_heads() as heads, kv_columns() as kv:
        api.forward(lm, inputs, mesh)
    _, info, _ = build_train_step(api, TrainConfig(remat="none"), mesh)
    with kv_columns() as train:
        info["value_and_grad"](place_model(lm, make_rules(mesh)), batch)
    return {"heads": heads, "kv": kv, "train_kv": train,
            "decode_kv": kv_decode(cfg, mesh)}


def head_groups_body(rank: int, out_dir: str) -> Dict:
    """Every case of ``test_torch_head_groups.py`` that needs ranks: for
    each of ``HEAD_CASES`` on each mesh the forward, the decode steps,
    the gradients (with the heads each score held and the columns of each
    K/V projection) and TRAIN_STEPS AdamW steps; ``HEAD_KV3``'s forward
    on 1 x 4; :func:`kv_case` of ``KV_LLAMA``."""
    import repro_torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_config
    with np.load(os.path.join(out_dir, "inputs.npz")) as z:
        flat = {k.replace("__", "/"): z[k] for k in z.files}
    out = {}
    with repro_torch.use_device("cpu"):
        meshes = {name: make_mesh(shape, axes)
                  for name, (shape, axes) in MESHES.items()}
        for name, arch, H, KV in HEAD_CASES:
            cfg = head_cfg(get_config, arch, H, KV)
            for m, mesh in meshes.items():
                key = f"{name}/{m}"
                out[key] = _head_forward(cfg, mesh, flat, name)
                with scored_heads() as heads, whole_reads() as whole, \
                        kv_columns() as kv:
                    out[f"{key}/grads"] = _grads_of(cfg, mesh, flat, name,
                                                    f"{name}/batch0/")
                out[f"{key}/grads"].update(heads=heads, whole_reads=whole,
                                           kv=kv)
                out[f"{key}/steps"] = _steps_of(cfg, mesh, "adamw", flat,
                                                name)
        name, arch, H, KV = HEAD_KV3
        out[f"{name}/1x4"] = _head_forward(head_cfg(get_config, arch, H, KV),
                                           meshes["1x4"], flat, name)
        name, arch, H, KV = KV_LLAMA
        out[f"{name}/{KV_LLAMA_MESH}"] = kv_case(
            head_cfg(get_config, arch, H, KV), meshes[KV_LLAMA_MESH])
    return out


# ---------------------------------------------------------------------------
# test_torch_ssd_heads.py's ranks
# ---------------------------------------------------------------------------

# reduced Mamba2 configurations (SSM head dim 16) on 1 x 4: (name, arch,
# d_model). 16 heads each, 4 a rank; and 6, whose 1.5 heads a rank do not
# tile out_proj's rows: 2 a rank, the head at each seam run by both ranks
SSD_CASES = (("mamba2", "mamba2-130m", 128), ("zamba2", "zamba2-1.2b", 128),
             ("h6", "mamba2-130m", 48))
SSD_MESH = "1x4"
SSD_SHAPE = (4, 32)            # (B, S): two chunks of 16
# the pin at 1 x 16, one layer each: mamba2-130m's 24 heads and
# zamba2-1.2b's 64
SSD_WIDE = (("mamba2", "mamba2-130m", 192), ("zamba2", "zamba2-1.2b", 512))
SSD_WIDE_TP = 16


def ssd_cfg(get_config, arch: str, d_model: int, n_layers=None):
    """An SSD-heads case's configuration in either package: ``arch``
    reduced at width ``d_model`` (``2 d_model / 16`` SSM heads), float32
    compute, ``n_layers`` layers where given."""
    cfg = dataclasses.replace(get_config(arch).reduced(), d_model=d_model,
                              compute_dtype="float32")
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


@contextlib.contextmanager
def ssd_heads():
    """The SSM heads of each SSD within chunks (``mamba2._ssd_intra``'s
    ``la``, (B, nc, Q, heads)) while the enclosed code runs (a list that
    fills)."""
    from repro_torch.models import mamba2
    seen = []
    intra = mamba2._ssd_intra

    def spy(la, *a):
        seen.append(int(la.shape[-1]))
        return intra(la, *a)

    mamba2._ssd_intra = spy
    try:
        yield seen
    finally:
        mamba2._ssd_intra = intra


def ssd_body(rank: int, out_dir: str) -> Dict:
    """Every case of ``test_torch_ssd_heads.py`` that needs ranks: for
    each of ``SSD_CASES`` on ``SSD_MESH`` the forward as this rank holds
    its logits and the gradients, each with the heads of every SSD."""
    import repro_torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, get_config
    from repro_torch.models.carry import params_from_reference
    with np.load(os.path.join(out_dir, "inputs.npz")) as z:
        flat = {k.replace("__", "/"): z[k] for k in z.files}
    out = {}
    with repro_torch.use_device("cpu"):
        mesh = make_mesh(*MESHES[SSD_MESH])
        for name, arch, d in SSD_CASES:
            cfg = ssd_cfg(get_config, arch, d)
            lm = params_from_reference(cfg, _tree_from(flat,
                                                       f"{name}/params/"),
                                       device="cpu")
            batch = _batch(flat, f"{name}/batch0/")
            batch.pop("labels")
            with ssd_heads() as heads:
                logits = build_model(cfg).forward(lm, batch, mesh)
            out[name] = {"forward": _np(logits), "heads": heads}
            with ssd_heads() as heads:
                out[f"{name}/grads"] = _grads_of(cfg, mesh, flat, name,
                                                 f"{name}/batch0/")
            out[f"{name}/grads"]["heads"] = heads
    return out
