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

import dataclasses
import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
TIMEOUT = 120.0
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
PIPE_SHAPE = (8, 16, 6, 2)     # (L, D, n_micro, mb)


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


# ---------------------------------------------------------------------------
# test_torch_sharding.py's ranks
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
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
    from repro_torch.models import layers
    out = {}
    for name, mesh in meshes.items():
        for H, KV in FLASH_HEADS:
            key = f"flash/{name}/{H}x{KV}"
            if key + "/q" not in flat:
                continue
            q, k, v = (torch.from_numpy(flat[f"{key}/{t}"])
                       for t in ("q", "k", "v"))
            out[key] = _np(layers.flash_sdpa(q, k, v, mesh, causal=True))
    return out


def _with_dtensor_params(lm, mesh):
    """``lm``'s parameters replaced by DTensors placed as the partition
    rules say (FSDP on "data", TP on "model")."""
    from repro_torch.sharding.partition import make_rules, place, placements
    rules = make_rules(mesh)
    for name, w in list(lm.named_parameters()):
        mod, _, attr = name.rpartition(".")
        owner = lm.get_submodule(mod)
        where = placements(mesh, rules.spec(type(owner).AXES[attr]))
        setattr(owner, attr, torch.nn.Parameter(
            place(w.detach(), mesh, where), requires_grad=False))
    return lm


def flash_kw(cfg) -> Dict:
    """The forward's flash argument where the family has one."""
    return {} if cfg.family in ("ssm", "hybrid") else {"flash": True}


def _forward_cases(mesh, flat) -> Dict:
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.carry import params_from_reference
    out = {}
    B, S = FORWARD_SHAPE
    for arch in FORWARD_ARCHS:
        cfg = _f32(arch)
        api = build_model(cfg)
        tree = _tree_from(flat, f"{arch}/params/")
        lm = params_from_reference(cfg, tree, device="cpu")
        tokens = torch.from_numpy(flat[f"{arch}/tokens"])
        out[f"{arch}/forward"] = _np(api.forward(lm, {"tokens": tokens},
                                                 mesh, **flash_kw(cfg)))
        cache, _ = api.init_cache(B, DECODE_STEPS + 1)
        steps = []
        for t in range(DECODE_STEPS):
            logits, cache = api.decode_step(lm, cache, tokens[:, t:t + 1], t,
                                            mesh)
            steps.append(_np(logits))
        out[f"{arch}/decode"] = np.stack(steps)
        serve_step, info = build_serve_step(api, mesh, batch=B,
                                            max_len=DECODE_STEPS + 1)
        logits, _ = serve_step(lm, api.init_cache(B, DECODE_STEPS + 1)[0],
                               tokens[:, :1], 0)
        out[f"{arch}/serve_step"] = _np(logits)
        out[f"{arch}/serve_info"] = sorted(info)
        placed = _with_dtensor_params(
            params_from_reference(cfg, tree, device="cpu"), mesh)
        out[f"{arch}/forward_dtensor"] = _np(api.forward(
            placed, {"tokens": tokens}, mesh, **flash_kw(cfg)))
    out["train_raises"] = _training_raises(api, lm, tokens, mesh)
    return out


def _training_raises(api, lm, tokens, mesh):
    """The messages of the training entry points given a DeviceMesh."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import build_train_step
    said = []
    for call in (lambda: api.loss_fn(lm, {"tokens": tokens,
                                          "labels": tokens}, mesh),
                 lambda: build_train_step(api, TrainConfig(), mesh)):
        try:
            call()
            said.append("")
        except NotImplementedError as e:
            said.append(str(e))
    return said


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
        out.update(_forward_cases(meshes["2x2"], flat))
        out.update(_pipeline_cases(flat))
        out.update(_shard_act_cases(meshes["2x2"]))
        out.update(_restore_cases(meshes["2x2"], out_dir))
    return out
