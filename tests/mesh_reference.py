"""The JAX package's side of ``test_torch_sharding.py``'s cases across
ranks, on four forced host devices (pytest collects nothing here).

    python tests/mesh_reference.py DIR

reads ``DIR/inputs.npz`` (written by the test) and writes every
reference output to ``DIR/ref.npz``: ``repro``'s ``moe_apply_ep`` at
the config's capacity, its tensor-parallel ``flash_sdpa``, the reduced
models' forwards and decode steps, reduced llama3-8b's loss, and its
four-stage GPipe schedule, on the meshes of ``torch_ranks.MESHES``.

The forwards and decode steps (``torch_ranks.LOGITS_CASES``) run as the
reference's dry run lowers them: the forward jitted with ``in_shardings``
from ``make_rules(mesh, fsdp=False)`` (its output placed by XLA's
propagation), the decode step through ``build_serve_step``. Each
device's shard of the logits is written under its flat mesh coordinate
(the port's rank at that coordinate), and ``DIR/ref.json`` holds each
output's ``PartitionSpec`` and each shard's index.

    python tests/mesh_reference.py DIR heads
    python tests/mesh_reference.py DIR pin16

are ``test_torch_head_groups.py``'s sides: ``heads`` runs, on the four
devices, each of ``torch_ranks.HEAD_CASES`` on each mesh (the forward and
decode steps as above, ``jax.grad`` of ``loss_fn`` and three steps of
``build_train_step`` as ``train_mesh_reference.py`` runs them) and
``HEAD_KV3``'s forward on 1 x 4, and only compiles ``KV_LLAMA``'s
forward, train step and decode step on 2 x 2; ``pin16`` only compiles
``KV_WIDE``'s on 16 devices at 1 x 16, and ``KV_DECODE``'s decode step.
Each decode step is compiled under ``make_rules(mesh, fsdp=False)`` and
under the rules the reference's dry run decodes with. Both write the
heads of each compiled score ``dot`` per device, the columns of each K/V
projection ``dot`` per device and each decode step's all-gathers of a
whole cache (``compiled.as_text()``) to ``DIR/<mode>.json`` beside
``DIR/<mode>.npz``.

    python tests/mesh_reference.py DIR ssd
    python tests/mesh_reference.py DIR ssd16

are ``test_torch_ssd_heads.py``'s sides: ``ssd`` runs, on the four
devices, each of ``torch_ranks.SSD_CASES`` on 1 x 4 (the forward as
above and ``jax.grad`` of ``loss_fn``) and compiles one step of
``build_train_step``; ``ssd16`` only compiles ``SSD_WIDE``'s forward and
train step on 16 devices at 1 x 16. Both write the SSM heads of the
SSD's float32 (B, nc, heads, Q, Q) tensors per device to
``DIR/<mode>.json``.
"""

import dataclasses
import inspect
import json
import os
import re
import sys

DEVICES = 16 if sys.argv[2:] in (["pin16"], ["ssd16"]) else 4
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={DEVICES}"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, "src"), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro.core.acc_state import flatten_checksums  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.specs import make_batch  # noqa: E402
from repro.launch.steps import (build_serve_step,  # noqa: E402
                                build_train_step)
from repro.models import layers as L  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.models.registry import build_model, get_config  # noqa: E402
from repro.optim import init_error_state  # noqa: E402
from repro.sharding.partition import (batch_shardings, make_rules,  # noqa: E402
                                      params_shardings)
from repro.sharding.pipeline import pipeline_apply, stage_params  # noqa: E402

import torch_ranks as R  # noqa: E402


def _f32(arch: str) -> ModelConfig:
    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")


def _tree(flat, prefix):
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        *heads, last = k[len(prefix):].split("/")
        d = out
        for h in heads:
            d = d.setdefault(h, {})
        d[last] = jnp.asarray(v)
    return out


def _shards(x, mesh):
    """(each device's shard in flat mesh-coordinate order, the spec and
    each shard's index as [start, stop] per dim)."""
    by_dev = {s.device: s for s in x.addressable_shards}
    shards, index = [], []
    for dev in mesh.devices.flat:
        sh = by_dev[dev]
        shards.append(np.asarray(sh.data))
        index.append([[sl.start or 0, n if sl.stop is None else sl.stop]
                      for sl, n in zip(sh.index, x.shape)])
    return shards, {"spec": str(x.sharding.spec), "index": index}


def _logits_cases(meshes, flat, out, meta) -> None:
    B, _ = R.FORWARD_SHAPE
    for name, arch, vocab in R.LOGITS_CASES:
        mesh = meshes[name]
        key = R.logits_key(name, arch, vocab)
        cfg = R.logits_cfg(get_config, arch, vocab)
        api = build_model(cfg)
        params = _tree(flat, f"{arch}/params/")
        tokens = jnp.asarray(R.logits_tokens(flat, arch, vocab))
        rules = make_rules(mesh, fsdp=False)
        _, axes = api.abstract_init(jax.random.PRNGKey(0))
        psh = params_shardings(rules, axes)
        params = jax.device_put(params, psh)
        batch = {"tokens": tokens}
        kw = R.flash_kw(cfg)
        fwd = jax.jit(lambda p, b: api.forward(p, b, mesh, **kw),
                      in_shardings=(psh, batch_shardings(rules, batch)))
        shards, meta[f"{key}/forward"] = _shards(fwd(params, batch), mesh)
        for i, x in enumerate(shards):
            out[f"{key}/forward/{i}"] = x
        step, sh = build_serve_step(api, rules, batch=B,
                                    max_len=R.DECODE_STEPS + 1,
                                    donate=False)
        cache = jax.device_put(api.init_cache(B, R.DECODE_STEPS + 1)[0],
                               sh["cache"])
        steps = []
        for t in range(R.DECODE_STEPS):
            logits, cache = step(params, cache, tokens[:, t:t + 1],
                                 jnp.int32(t))
            shards, meta[f"{key}/decode"] = _shards(logits, mesh)
            steps.append(shards)
        for i in range(len(steps[0])):
            out[f"{key}/decode/{i}"] = np.stack([s[i] for s in steps])


def main(out_dir: str) -> None:
    assert len(jax.devices()) == R.WORLD, jax.devices()
    with np.load(os.path.join(out_dir, "inputs.npz")) as z:
        flat = {k.replace("__", "/"): z[k] for k in z.files}
    meshes = {name: make_mesh(shape, axes)
              for name, (shape, axes) in R.MESHES.items()}
    out, meta = {}, {}

    cfg = _f32("kimi-k2-1t-a32b")
    p = {k: jnp.asarray(flat[f"moe/{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    for name, n in R.MOE_CASES:
        mesh = meshes[name]
        out[f"moe/{name}/{n}/cfg"] = moe.moe_apply_ep(
            cfg, p, jnp.asarray(flat[f"moe/x{n}"]), mesh,
            token_axes=tuple(mesh.axis_names))

    for name, mesh in meshes.items():
        for H, KV in R.FLASH_HEADS:
            key = f"flash/{name}/{H}x{KV}"
            if key + "/q" in flat:
                q, k, v = (jnp.asarray(flat[f"{key}/{t}"])
                           for t in ("q", "k", "v"))
                out[key] = L.flash_sdpa(q, k, v, mesh, causal=True)

    _logits_cases(meshes, flat, out, meta)
    mesh = meshes["2x2"]

    cfg = _f32("llama3-8b")
    tokens = jnp.asarray(flat["llama3-8b/tokens"])
    out["train/loss_fn"] = build_model(cfg).loss_fn(
        _tree(flat, "llama3-8b/params/"),
        {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}, mesh)

    W, x = jnp.asarray(flat["pipe/W"]), jnp.asarray(flat["pipe/x"])

    def stage_fn(ps, act):
        h, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), act, ps)
        return h

    out["pipe/four"] = pipeline_apply(stage_fn, stage_params(W, R.WORLD), x,
                                      make_mesh((R.WORLD,), ("stage",)))
    np.savez(os.path.join(out_dir, "ref.npz"),
             **{k.replace("/", "__"): np.asarray(v, np.float32)
                for k, v in out.items()})
    with open(os.path.join(out_dir, "ref.json"), "w") as fh:
        json.dump(meta, fh)


def _scored_heads(compiled, S: int) -> list:
    """The heads of each float32 ``dot`` with a trailing (S, S) (the
    attention scores, their gradients) in a compiled program's text: its
    per-device shape (B_loc, heads, S, S)."""
    return [int(d.split(",")[1]) for d in
            re.findall(r"= f32\[([0-9,]+)\]\S* dot\(", compiled.as_text())
            if d.split(",")[-2:] == [str(S), str(S)]]


def _kv_columns(compiled, T: int) -> list:
    """The columns of each float32 ``dot`` of shape (T, c) whose source is
    ``repro``'s K or V projection (the ``p["wk"]`` / ``p["wv"]`` lines of
    ``layers.attention_apply``, read from the stack frames a compiled
    program's text carries): per device, (B_loc * S, c) contracting
    ``d_model``."""
    text = compiled.as_text()
    tables, rows = {}, None
    for line in text.splitlines():
        if line in ("FileNames", "FileLocations", "StackFrames"):
            rows = tables.setdefault(line, {})
        elif not line.strip():
            rows = None
        elif rows is not None:
            i, rest = line.split(" ", 1)
            rows[int(i)] = rest
    src, first = inspect.getsourcelines(L.attention_apply)
    lines = {first + i for i, s in enumerate(src)
             if 'p["wk"]' in s or 'p["wv"]' in s}
    path = inspect.getsourcefile(L)
    files = {i: f.strip('"') for i, f in tables["FileNames"].items()}
    where = {i: (files[int(re.search(r"file_name_id=(\d+)", s).group(1))],
                 int(re.search(r" line=(\d+)", s).group(1)))
             for i, s in tables["FileLocations"].items()}
    frame = {i: int(re.search(r"file_location_id=(\d+)", s).group(1))
             for i, s in tables["StackFrames"].items()}
    out = []
    for n, c, f in re.findall(
            r"= f32\[(\d+),(\d+)\]\S* dot\(.*stack_frame_id=(\d+)", text):
        file, line = where[frame[int(f)]]
        if file == path and line in lines and int(n) == T:
            out.append(int(c))
    return out


def _ssd_heads(compiled, Q: int) -> list:
    """The heads of each float32 rank-5 tensor with a trailing (Q, Q) in a
    compiled program's text: per device (B_loc, nc, heads, Q, Q), the SSD's
    decays within chunks and what is made of them (and, where the head
    dim and the state are Q as well, its chunk states (B_loc, nc, heads,
    hd, N))."""
    return [int(d.split(",")[2]) for d in
            re.findall(r"f32\[([0-9,]+)\]", compiled.as_text())
            if d.count(",") == 4 and d.split(",")[-2:] == [str(Q)] * 2]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _batch(flat, prefix):
    return {k[len(prefix):]: jnp.asarray(v) for k, v in flat.items()
            if k.startswith(prefix)}


def _head_forward(cfg, mesh, flat, src, key, out, meta) -> None:
    """The forward (jitted as in ``_logits_cases``, its compiled scores'
    heads in ``meta``) and the decode steps of a head-group case."""
    B, S = R.HEAD_SHAPE
    api = build_model(cfg)
    rules = make_rules(mesh, fsdp=False)
    _, axes = api.abstract_init(jax.random.PRNGKey(0))
    psh = params_shardings(rules, axes)
    params = jax.device_put(_tree(flat, f"{src}/params/"), psh)
    batch = _batch(flat, f"{src}/batch0/")
    batch.pop("labels")
    tokens = batch["tokens"]
    fwd = jax.jit(lambda p, b: api.forward(p, b, mesh),
                  in_shardings=(psh, batch_shardings(rules, batch)))
    compiled = fwd.lower(params, batch).compile()
    meta[f"{key}/heads"] = _scored_heads(compiled, S)
    meta[f"{key}/kv"] = _kv_columns(compiled, _rows(mesh, B, S))
    shards, meta[f"{key}/forward"] = _shards(fwd(params, batch), mesh)
    for i, x in enumerate(shards):
        out[f"{key}/forward/{i}"] = x
    step, sh = build_serve_step(api, rules, batch=B,
                                max_len=R.DECODE_STEPS + 1, donate=False)
    cache = jax.device_put(api.init_cache(B, R.DECODE_STEPS + 1)[0],
                           sh["cache"])
    steps = []
    for t in range(R.DECODE_STEPS):
        logits, cache = step(params, cache, tokens[:, t:t + 1], jnp.int32(t))
        steps.append(_shards(logits, mesh)[0])
    for i in range(len(steps[0])):
        out[f"{key}/decode/{i}"] = np.stack([s[i] for s in steps])


def _rows(mesh, B: int, S: int) -> int:
    """A device's rows of the (B * S, d_model) activations: its block of
    the batch over "data", every position."""
    return B // mesh.shape["data"] * S


def _cache_gathers(compiled, shape) -> int:
    """The all-gathers in a compiled program's text whose result is a
    float32 tensor of ``shape``: a device's whole K or V cache."""
    dims = ",".join(map(str, shape))
    return len(re.findall(rf"= f32\[{dims}\]\S* all-gather(?:-start)?\(",
                          compiled.as_text()))


def _kv_decode_compiled(cfg, mesh, key, meta) -> None:
    """Compiles only, on abstract weights: one decode step of
    ``build_serve_step`` under ``make_rules(mesh, fsdp=False)`` and again
    under the rules the reference's dry run decodes with (the cache's KV
    heads over "model" where the TP degree divides them, attention heads
    whole: ``launch/dryrun.py``'s decode branch). The K/V columns of each
    (:func:`_kv_columns`) and its all-gathers of a device's whole K or V
    cache (:func:`_cache_gathers`) in ``meta``."""
    B = R.HEAD_SHAPE[0]
    api = build_model(cfg)
    params, _ = api.abstract_init(jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: api.init_cache(B, R.DECODE_STEPS + 1)[0])
    tp = mesh.shape["model"]
    whole = list(cache["k"].shape)
    whole[1] //= mesh.shape["data"]
    for name, rules in (
            ("decode", make_rules(mesh, fsdp=False)),
            ("decode_rules", make_rules(
                mesh, fsdp=False,
                kv_cache_heads_shardable=cfg.n_kv_heads % tp == 0,
                replicate_attn_heads=True))):
        serve, _ = build_serve_step(api, rules, batch=B,
                                    max_len=R.DECODE_STEPS + 1, donate=False)
        compiled = serve.lower(params, cache,
                               jax.ShapeDtypeStruct((B, 1), jnp.int32),
                               jnp.int32(0)).compile()
        meta[f"{key}/{name}_kv"] = _kv_columns(compiled, _rows(mesh, B, 1))
        meta[f"{key}/{name}_gathers"] = _cache_gathers(compiled, whole)


def _kv_compiled(cfg, mesh, key, meta) -> None:
    """Compiles only, on abstract weights: ``cfg``'s forward jitted as in
    ``_logits_cases``, one step of ``build_train_step`` on
    ``make_rules(mesh)`` and the decode steps of
    :func:`_kv_decode_compiled`; the K/V columns of each
    (:func:`_kv_columns`) and the forward's scored heads in ``meta``."""
    B, S = R.HEAD_SHAPE
    api = build_model(cfg)
    params, axes = api.abstract_init(jax.random.PRNGKey(0))
    rules = make_rules(mesh, fsdp=False)
    batch = jax.eval_shape(lambda: make_batch(cfg, B, S,
                                              jax.random.PRNGKey(0)))
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    fwd = jax.jit(lambda p, b: api.forward(p, b, mesh),
                  in_shardings=(params_shardings(rules, axes),
                                batch_shardings(rules, inputs)))
    compiled = fwd.lower(params, inputs).compile()
    meta[f"{key}/heads"] = _scored_heads(compiled, S)
    meta[f"{key}/kv"] = _kv_columns(compiled, _rows(mesh, B, S))
    step, _, opt_init = build_train_step(
        api, R.train_tcfg(TrainConfig, "adamw"), make_rules(mesh),
        donate=False)
    meta[f"{key}/train_kv"] = _kv_columns(step.lower(
        params, jax.eval_shape(opt_init, params),
        jax.eval_shape(init_error_state, params), batch,
        jax.random.PRNGKey(0)).compile(), _rows(mesh, B, S))
    _kv_decode_compiled(cfg, mesh, key, meta)


def _head_train(cfg, mesh, flat, src, key, out, meta) -> None:
    """``jax.grad`` of ``loss_fn`` and TRAIN_STEPS AdamW steps of
    ``build_train_step`` on ``make_rules(mesh)`` (its compiled scores'
    heads in ``meta``) of a head-group case."""
    api = build_model(cfg)
    params = _tree(flat, f"{src}/params/")
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: api.loss_fn(p, b, mesh)))(
        params, _batch(flat, f"{src}/batch0/"))
    out[f"{key}/grads/loss"] = loss
    for p, g in _paths(grads):
        out[f"{key}/grads/{p}"] = g
    step, _, opt_init = build_train_step(
        api, R.train_tcfg(TrainConfig, "adamw"), make_rules(mesh),
        donate=False)
    p, o, e = params, opt_init(params), init_error_state(params)
    compiled = step.lower(p, o, e, _batch(flat, f"{src}/batch0/"),
                          jax.random.PRNGKey(0)).compile()
    meta[f"{key}/train_heads"] = _scored_heads(compiled, R.HEAD_SHAPE[1])
    meta[f"{key}/train_kv"] = _kv_columns(compiled, _rows(mesh,
                                                          *R.HEAD_SHAPE))
    for t in range(R.TRAIN_STEPS):
        p, o, e, m, c = step(p, o, e, _batch(flat, f"{src}/batch{t}/"),
                             jax.random.PRNGKey(t))
        out[f"{key}/steps/{t}/loss"] = m["loss"]
        out[f"{key}/steps/{t}/grad_norm"] = m["grad_norm"]
        for k in ("params", "opt", "updates"):
            out[f"{key}/steps/{t}/{k}"] = np.asarray(flatten_checksums(c[k]))
    for path, w in _paths(p):
        out[f"{key}/steps/params/{path}"] = w


def _ssd_case(cfg, mesh, params, batch, key, out, meta,
              run: bool = True) -> None:
    """An SSD-heads case on ``mesh``: the forward jitted as in
    ``_logits_cases`` and one step of ``build_train_step`` on
    ``make_rules(mesh)`` compiled, the heads of each one's SSD
    (:func:`_ssd_heads`) in ``meta``; where ``run``, each device's shard of
    the forward's logits and ``jax.grad`` of ``loss_fn`` on the mesh."""
    api = build_model(cfg)
    Q = min(cfg.ssm_chunk, R.SSD_SHAPE[1])
    rules = make_rules(mesh, fsdp=False)
    _, axes = api.abstract_init(jax.random.PRNGKey(0))
    psh = params_shardings(rules, axes)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    fwd = jax.jit(lambda p, b: api.forward(p, b, mesh),
                  in_shardings=(psh, batch_shardings(rules, inputs)))
    placed = jax.device_put(params, psh)
    meta[f"{key}/heads"] = _ssd_heads(fwd.lower(placed, inputs).compile(), Q)
    step, _, opt_init = build_train_step(
        api, R.train_tcfg(TrainConfig, "adamw"), make_rules(mesh),
        donate=False)
    meta[f"{key}/train_heads"] = _ssd_heads(step.lower(
        params, opt_init(params), init_error_state(params), batch,
        jax.random.PRNGKey(0)).compile(), Q)
    if not run:
        return
    shards, meta[f"{key}/forward"] = _shards(fwd(placed, inputs), mesh)
    for i, x in enumerate(shards):
        out[f"{key}/forward/{i}"] = x
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: api.loss_fn(p, b, mesh)))(params, batch)
    out[f"{key}/grads/loss"] = loss
    for p, g in _paths(grads):
        out[f"{key}/grads/{p}"] = g


def ssd_main(out_dir: str, mode: str) -> None:
    """``ssd``: each of ``R.SSD_CASES`` on ``R.SSD_MESH`` from the test's
    inputs; ``ssd16``: ``R.SSD_WIDE`` at 1 x 16, compiled only."""
    assert len(jax.devices()) == DEVICES, jax.devices()
    out, meta = {}, {}
    B, S = R.SSD_SHAPE
    if mode == "ssd16":
        mesh = make_mesh((1, R.SSD_WIDE_TP), ("data", "model"))
        for name, arch, d in R.SSD_WIDE:
            cfg = R.ssd_cfg(get_config, arch, d, n_layers=1)
            params, _ = build_model(cfg).init(jax.random.PRNGKey(0))
            _ssd_case(cfg, mesh, params,
                      make_batch(cfg, B, S, jax.random.PRNGKey(1)), name,
                      out, meta, run=False)
    else:
        with np.load(os.path.join(out_dir, "inputs.npz")) as z:
            flat = {k.replace("__", "/"): z[k] for k in z.files}
        shape, axes = R.MESHES[R.SSD_MESH]
        mesh = make_mesh(shape, axes)
        for name, arch, d in R.SSD_CASES:
            _ssd_case(R.ssd_cfg(get_config, arch, d), mesh,
                      _tree(flat, f"{name}/params/"),
                      _batch(flat, f"{name}/batch0/"), name, out, meta)
    np.savez(os.path.join(out_dir, f"{mode}.npz"),
             **{k.replace("/", "__"): np.asarray(v, np.float32)
                for k, v in out.items()})
    with open(os.path.join(out_dir, f"{mode}.json"), "w") as fh:
        json.dump(meta, fh)


def heads_main(out_dir: str, mode: str) -> None:
    assert len(jax.devices()) == DEVICES, jax.devices()
    out, meta = {}, {}
    if mode == "pin16":
        mesh = make_mesh((1, R.HEAD_WIDE_TP), ("data", "model"))
        for name, arch, H, KV in R.KV_WIDE:
            _kv_compiled(R.wide_cfg(get_config, arch, H, KV), mesh, name,
                         meta)
        name, arch, H, KV = R.KV_DECODE
        _kv_decode_compiled(R.wide_cfg(get_config, arch, H, KV), mesh, name,
                            meta)
    else:
        with np.load(os.path.join(out_dir, "inputs.npz")) as z:
            flat = {k.replace("__", "/"): z[k] for k in z.files}
        meshes = {name: make_mesh(shape, axes)
                  for name, (shape, axes) in R.MESHES.items()}
        for name, arch, H, KV in R.HEAD_CASES:
            cfg = R.head_cfg(get_config, arch, H, KV)
            for m, mesh in meshes.items():
                _head_forward(cfg, mesh, flat, name, f"{name}/{m}", out, meta)
                _head_train(cfg, mesh, flat, name, f"{name}/{m}", out, meta)
        name, arch, H, KV = R.HEAD_KV3
        _head_forward(R.head_cfg(get_config, arch, H, KV), meshes["1x4"],
                      flat, name, f"{name}/1x4", out, meta)
        name, arch, H, KV = R.KV_LLAMA
        _kv_compiled(R.head_cfg(get_config, arch, H, KV),
                     meshes[R.KV_LLAMA_MESH], f"{name}/{R.KV_LLAMA_MESH}",
                     meta)
    np.savez(os.path.join(out_dir, f"{mode}.npz"),
             **{k.replace("/", "__"): np.asarray(v, np.float32)
                for k, v in out.items()})
    with open(os.path.join(out_dir, f"{mode}.json"), "w") as fh:
        json.dump(meta, fh)


if __name__ == "__main__":
    if sys.argv[2:] in (["ssd"], ["ssd16"]):
        ssd_main(sys.argv[1], sys.argv[2])
    elif sys.argv[2:]:
        heads_main(sys.argv[1], sys.argv[2])
    else:
        main(sys.argv[1])
