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
        out.update(_training_cases(meshes["2x2"], flat))
        out.update(_c1_cases(meshes, flat))
        out.update(_pipeline_cases(flat))
        out.update(_shard_act_cases(meshes["2x2"]))
        out.update(_restore_cases(meshes["2x2"], out_dir))
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
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import (build_opt_shardings,
                                          build_train_step, place_model)
    from repro_torch.models import build_model, get_config
    from repro_torch.models.carry import (opt_tree, param_axes,
                                          params_from_reference,
                                          params_to_reference, tree_items)
    from repro_torch.optim import init_error_state
    from repro_torch.sharding.partition import (make_rules,
                                                params_shardings)
    cfg = train_cfg(get_config, arch)
    tcfg = train_tcfg(TrainConfig, optimizer, grad_compression=compression)
    lm = params_from_reference(cfg, _tree_from(flat, f"{arch}/params/"),
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
        batch = {k: torch.from_numpy(flat[f"{arch}/batch{t}/{k}"])
                 for k in ("tokens", "labels")}
        lm, opt, err, m, c = step(lm, opt, err, batch,
                                  torch.Generator().manual_seed(t))
        out[f"{t}/loss"] = float(m["loss"])
        out[f"{t}/grad_norm"] = float(m["grad_norm"])
        out[f"{t}/checksums"] = _flat_checksums(c)
    out["params"] = dict(tree_items(params_to_reference(cfg, lm)))
    return out


def _grads(arch, mesh, flat) -> Dict:
    """The step's ``value_and_grad`` across the ranks: the loss and every
    leaf's global gradient in the reference's layout."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import build_train_step, place_model
    from repro_torch.models import build_model, get_config
    from repro_torch.models.carry import (params_from_reference,
                                          reference_tree, to_host,
                                          tree_items)
    from repro_torch.sharding.partition import make_rules
    cfg = train_cfg(get_config, arch)
    lm = place_model(params_from_reference(
        cfg, _tree_from(flat, f"{arch}/params/"), device="cpu"),
        make_rules(mesh))
    _, info, _ = build_train_step(build_model(cfg),
                                  TrainConfig(remat="none"), mesh)
    batch = {k: torch.from_numpy(flat[f"{arch}/batch0/{k}"])
             for k in ("tokens", "labels")}
    loss, grads = info["value_and_grad"](lm, batch)
    return {"loss": float(loss),
            "grads": {p: to_host(x) for p, x in
                      tree_items(reference_tree(cfg, grads))}}


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
        out["int8"] = _steps("llama3-8b", meshes["2x2"], "adamw", flat,
                             compression="int8")
        out.update(_trainer_cases(rank, meshes["2x2"], out_dir))
    return out
