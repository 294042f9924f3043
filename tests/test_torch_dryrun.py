"""Port vs reference, the multi-pod dry run (``repro_torch.launch.dryrun``,
``launch.specs.batch_specs`` / ``decode_specs``).

* ``applicable_shapes`` equals the reference's for all ten archs, skip
  reasons letter for letter.
* ``batch_specs`` / ``decode_specs``: every leaf's shape and type equal to
  the reference's ``ShapeDtypeStruct`` (its cache from ``jax.eval_shape``
  of the arch's ``init_cache``), for every arch and applicable shape.
* Rank 0's share of every argument leaf at full width, for all 62 cells
  of both production meshes: the port places parameters, optimizer
  state, batch, decode tokens and cache on a fake group of 256 or 512
  ranks, and each local shape must equal the reference's per-device
  ``NamedSharding(AbstractMesh, spec).shard_shape`` from its own
  ``params_shardings``, ``build_opt_shardings``, ``batch_shardings`` and
  ``cache_shardings`` (no lowering, no compile). ``shard_shape`` raises
  where a dim does not divide (granite-3-8b's vocab of 49 155 over 16);
  XLA pads such a dim to ``ceil(dim / n)`` per device, and that is what
  the port's ``torch.chunk`` gives rank 0, so the test compares with it.
  The logits that a prefill or decode cell's program returns are held
  the same way, against the reference's placement of them: a decode
  step's is ``build_serve_step``'s ``out_shardings`` (``P(dp, None,
  "model" if vocab_size % tp == 0 else None)``, ``dp`` None where the
  cache's positions take the data axis), a prefill's is what XLA's
  propagation gives the jitted forward (``P(dp, None, "model")``, or
  ``P(dp)`` where 16 does not divide the vocabulary: granite-3-8b,
  mamba2-130m, hubert-xlarge; pinned on four devices by
  ``test_torch_sharding.py``).
* FLOPs: reduced llama3-8b's and mamba2-130m's prefills on a (2, 2)
  fake group count, on rank 0, exactly the hand formula of their
  tensor-parallel layers (the Mamba2 rank's SSD for its own heads).
* One full-width cell end to end (llama3-8b ``decode_32k``, single pod)
  and the command line on one arch, whose records go under ``tmp_path``.
* The fake group is torn down after a cell that passes and one that
  fails, and a cell refuses to run where a group is already live.

The collectives of the dry run are held to a real 4-rank gloo run in
``test_torch_sharding.py``, whose ranks record them.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

import repro_torch
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.launch import specs as ref_specs
from repro.launch.steps import build_opt_shardings as ref_build_opt_shardings
from repro.models.registry import build_model as ref_build_model
from repro.models.registry import get_config as ref_get_config
from repro.optim import make_optimizer as ref_make_optimizer
from repro.sharding import partition as ref_partition
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_config, list_archs
from repro_torch.models.registry import family_module

ARCHS = list_archs()


def _reference_applicable_shapes():
    """The reference's ``applicable_shapes``, compiled from its source:
    importing ``repro.launch.dryrun`` would force 512 host devices on this
    process."""
    import ast
    import pathlib
    src = pathlib.Path(ref_specs.__file__).with_name("dryrun.py")
    fn = next(n for n in ast.parse(src.read_text()).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "applicable_shapes")
    ns = {"SHAPES": REF_SHAPES, "Dict": dict, "ModelConfig": object}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(src), "exec"),
         ns)
    return ns["applicable_shapes"]


REF_APPLICABLE = _reference_applicable_shapes()
CELLS = [(a, s, m) for a in ARCHS
         for s, why in REF_APPLICABLE(ref_get_config(a)).items()
         if why == "run" for m in (False, True)]


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in kp)


def _ref_leaves(tree):
    return {_path(kp): x for kp, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _ref_cache(cfg, B, S):
    api = ref_build_model(cfg)
    box = {}

    def cache_only():
        c, a = api.init_cache(B, S)
        box["axes"] = a
        return c

    return jax.eval_shape(cache_only), box["axes"]


# ---------------------------------------------------------------------------
# skips and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_shapes_match_reference(arch):
    assert dryrun.applicable_shapes(get_config(arch)) == \
        REF_APPLICABLE(ref_get_config(arch))


def test_cell_count():
    """62 cells run and 18 skip over both meshes, as in the reference."""
    runs = sum(why == "run" for a in ARCHS
               for why in dryrun.applicable_shapes(get_config(a)).values())
    assert (2 * runs, 2 * (len(ARCHS) * len(SHAPES) - runs)) == (62, 18)
    assert len(CELLS) == 62


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, why in dryrun.applicable_shapes(cfg).items():
        if why != "run":
            continue
        shape, rshape = SHAPES[name], REF_SHAPES[name]
        if shape.kind != "decode":
            got = specs.batch_specs(cfg, shape)
            want = ref_specs.batch_specs(rcfg, rshape)
            assert list(got) == list(want)
            for k, x in got.items():
                assert x.device.type == "meta"
                assert (tuple(x.shape), _dt(x)) == \
                    (tuple(want[k].shape), _dt(want[k])), (name, k)
            continue
        init = lambda B, S, device=None: family_module(cfg).init_cache(  # noqa: E731
            cfg, B, S, device=device)
        tok, cache, pos = specs.decode_specs(cfg, shape, init)
        rtok, rcache, rpos = ref_specs.decode_specs(
            rcfg, rshape, ref_build_model(rcfg).init_cache)
        assert (tuple(tok["tokens"].shape), _dt(tok["tokens"])) == \
            (tuple(rtok["tokens"].shape), _dt(rtok["tokens"]))
        assert (tuple(pos.shape), _dt(pos)) == (tuple(rpos.shape), _dt(rpos))
        from repro_torch.models.carry import tree_items
        got = {k: (tuple(v.shape), _dt(v), v.device.type)
               for k, v in tree_items(cache)}
        want = {k: (tuple(v.shape), _dt(v), "meta")
                for k, v in _ref_leaves(rcache).items()}
        assert got == want, name


# ---------------------------------------------------------------------------
# rank 0's share of every argument leaf, 62 cells at full width
# ---------------------------------------------------------------------------

def _device_shape(sh: NamedSharding, shape):
    """Per-device shape of ``shape`` under ``sh``; where a dim does not
    divide (``shard_shape`` raises) the ``ceil(dim / n)`` XLA pads to."""
    try:
        return tuple(sh.shard_shape(tuple(shape)))
    except ValueError:
        spec = tuple(sh.spec) + (None,) * (len(shape) - len(sh.spec))
        out = []
        for d, e in zip(shape, spec):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            out.append(-(-d // math.prod(sh.mesh.shape[a] for a in axes)))
        return tuple(out)


def _device_leaves(shapes, shardings):
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(flat) == len(shs)
    return {_path(kp): _device_shape(s, x.shape)
            for (kp, x), s in zip(flat, shs)}


def _ref_rank_leaves(arch, shape_name, multi):
    """The reference's per-device leaf shapes of a cell, as its
    ``lower_cell`` shards them."""
    cfg, shape = ref_get_config(arch), REF_SHAPES[shape_name]
    api = ref_build_model(cfg)
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
            else AbstractMesh((16, 16), ("data", "model")))
    tp = mesh.shape["model"]
    out = {}
    if shape.kind == "decode":
        kv_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % tp == 0
        d_inner = cfg.ssm_expand * cfg.d_model
        ssm_heads = (d_inner // cfg.ssm_head_dim) if cfg.ssm_state else 0
        rules = ref_partition.make_rules(
            mesh, fsdp=False, kv_cache_heads_shardable=kv_ok,
            shard_cache_seq=shape.global_batch < mesh.shape["data"],
            shard_ssm_heads=ssm_heads > 0 and ssm_heads % tp == 0,
            replicate_attn_heads=not cfg.use_mla)
        cache, axes = _ref_cache(cfg, shape.global_batch, shape.seq_len)
        out["cache"] = _device_leaves(
            cache, ref_partition.cache_shardings(rules, axes))
        dp = rules.table["batch"]
        tok = jax.ShapeDtypeStruct((shape.global_batch, 1), np.int32)
        spec = jax.sharding.PartitionSpec(dp, None) if dp is not None \
            else jax.sharding.PartitionSpec()
        out["tokens"] = {"tokens": _device_shape(NamedSharding(mesh, spec),
                                                 tok.shape)}
    else:
        tcfg = RefTrainConfig(remat="dots", optimizer="adafactor"
                              if arch.startswith("kimi") else "adamw")
        rules = ref_partition.make_rules(
            mesh, fsdp=tcfg.fsdp if shape.kind == "train" else False)
        batch = ref_specs.batch_specs(cfg, shape)
        out["batch"] = _device_leaves(
            batch, ref_partition.batch_shardings(rules, batch))
    if shape.kind != "train":
        dp = rules.table["batch"]
        vocab_ax = "model" if cfg.vocab_size % tp == 0 else None
        seq = 1 if shape.kind == "decode" else shape.seq_len
        out["outputs"] = {"logits": _device_shape(
            NamedSharding(mesh, jax.sharding.PartitionSpec(dp, None,
                                                           vocab_ax)),
            (shape.global_batch, seq, cfg.vocab_size))}
    pshapes, axes = api.abstract_init(jax.random.PRNGKey(0))
    psh = ref_partition.params_shardings(rules, axes)
    out["params"] = _device_leaves(pshapes, psh)
    if shape.kind == "train":
        init, _ = ref_make_optimizer(tcfg)
        out["opt"] = _device_leaves(
            jax.eval_shape(init, pshapes),
            ref_build_opt_shardings(tcfg, rules, psh, axes))
    return out


@pytest.mark.parametrize("arch,shape_name,multi", CELLS,
                         ids=[f"{a}-{s}-{'multi' if m else 'single'}"
                              for a, s, m in CELLS])
def test_rank_leaves_match_reference(arch, shape_name, multi):
    """Rank 0's argument leaves of the cell, and the logits its prefill or
    decode program returns, against ``repro``'s shardings. The logits'
    placement does not depend on depth, so the program that returns them
    runs the cell's config cut to two layers (at every width), which
    keeps the 42 programs on ``meta`` to seconds."""
    want = _ref_rank_leaves(arch, shape_name, multi)
    with dryrun.fake_group(512 if multi else 256):
        cell, mesh = dryrun.lower_cell(arch, shape_name, multi)
        got = dryrun.rank_leaves(cell)
        if "outputs" in want:
            cut = dataclasses.replace(cell.cfg,
                                      n_layers=min(2, cell.cfg.n_layers))
            short = dryrun.build_cell(cut, cell.shape, mesh)
            got["outputs"] = dryrun.rank_leaves(
                short, short.program())["outputs"]
    assert not dist.is_initialized()
    got.pop("err", None)
    assert sorted(got) == sorted(want)
    for group in want:
        assert got[group] == want[group], group


# ---------------------------------------------------------------------------
# FLOPs, one full-width cell, the command line, the group's lifetime
# ---------------------------------------------------------------------------

def test_flops_equal_hand_formula():
    """Rank 0 of reduced llama3-8b's plain prefill on (2, 2): q, o, the
    SwiGLU and the head split by the tensor-parallel degree, the K/V
    projections of the ``n_kv`` KV heads the rank's query heads read (one
    of the two here, as XLA projects them for ``repro``), attention
    ``4 B_loc S^2 H_loc hd``."""
    cfg = get_config("llama3-8b").reduced()
    B, S, dp, tp = 4, 16, 2, 2
    with dryrun.fake_group(dp * tp):
        mesh = make_mesh((dp, tp), ("data", "model"))
        cell = dryrun.build_cell(cfg, ShapeConfig("t", S, B, "prefill"),
                                 mesh)
        rec = dryrun.measure(cell)
    D, hd, F = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H_loc = cfg.n_heads // tp
    n_kv = max(1, H_loc // (cfg.n_heads // cfg.n_kv_heads))
    T = B // dp * S
    layer = (2 * T * D * H_loc * hd            # q
             + 2 * 2 * T * D * n_kv * hd       # k, v (the rank's KV heads)
             + 4 * (B // dp) * S * S * H_loc * hd   # q.k and p.v
             + 2 * T * H_loc * hd * D          # o
             + 3 * 2 * T * D * F // tp)        # gate, up, down
    head = 2 * T * D * cfg.padded_vocab // tp
    assert rec["cost_analysis"]["flops"] == cfg.n_layers * layer + head


def test_decode_flops_equal_hand_formula():
    """Rank 0 of reduced llama3-8b's decode step on (2, 2), whose cache the
    decode rules split by KV heads (2 over a TP degree of 2): q of the
    rank's ``H_loc`` heads, K and V of its ``KV / tp`` cache heads only
    (as XLA projects them for ``repro`` under those rules), the grouped
    scores and their product with v over its cache heads and all ``L``
    positions, o, the SwiGLU split by the tensor-parallel degree and the
    head. A rank that projected every KV head counts more."""
    cfg = get_config("llama3-8b").reduced()
    B, L, dp, tp = 4, 16, 2, 2
    with dryrun.fake_group(dp * tp):
        mesh = make_mesh((dp, tp), ("data", "model"))
        cell = dryrun.build_cell(cfg, ShapeConfig("t", L, B, "decode"),
                                 mesh)
        rec = dryrun.measure(cell)
    D, hd, F = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H_loc, kv_loc = cfg.n_heads // tp, cfg.n_kv_heads // tp
    T = B // dp                                 # one new token a row
    layer = (2 * T * D * H_loc * hd            # q
             + 2 * 2 * T * D * kv_loc * hd     # k, v (the rank's cache heads)
             + 4 * T * L * H_loc * hd          # q.k and p.v
             + 2 * T * H_loc * hd * D          # o
             + 3 * 2 * T * D * F // tp)        # gate, up, down
    head = 2 * T * D * cfg.padded_vocab // tp
    assert rec["cost_analysis"]["flops"] == cfg.n_layers * layer + head


def test_ssm_flops_equal_hand_formula():
    """Rank 0 of reduced mamba2-130m's plain prefill on (2, 2): the rank's
    ``in_proj`` columns (its rows' z, its heads' x and dt, B and C
    whole), the SSD of its ``ceil(H / tp)`` heads within chunks (the
    scores ``C.B`` whole, the masked product per head) and across them
    (each chunk's state and each position's output from it), ``out_proj``'s
    ``d_inner / tp`` rows and the head split by the tensor-parallel
    degree. A rank that ran all H heads counts more."""
    cfg = get_config("mamba2-130m").reduced()
    B, S, dp, tp = 4, 16, 2, 2
    with dryrun.fake_group(dp * tp):
        mesh = make_mesh((dp, tp), ("data", "model"))
        cell = dryrun.build_cell(cfg, ShapeConfig("t", S, B, "prefill"),
                                 mesh)
        rec = dryrun.measure(cell)
    D, N, hd = cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    d_loc = cfg.ssm_expand * D // tp
    H_loc = d_loc // hd                  # the heads tile the rows here
    B_loc, Q = B // dp, min(cfg.ssm_chunk, S)
    T, nc = B_loc * S, S // Q
    layer = (2 * T * D * (d_loc + H_loc * hd + 2 * N + H_loc)   # in_proj
             + 2 * B_loc * nc * Q * Q * N                # C.B scores
             + 2 * B_loc * nc * H_loc * Q * Q * hd       # within chunks
             + 2 * 2 * B_loc * nc * Q * N * H_loc * hd   # across chunks
             + 2 * T * d_loc * D)                        # out_proj
    head = 2 * T * D * cfg.padded_vocab // tp
    assert rec["cost_analysis"]["flops"] == cfg.n_layers * layer + head


def test_full_width_cell(tmp_path):
    rec = dryrun.run_cell("llama3-8b", "decode_32k", False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert not dist.is_initialized()
    for key in ("memory_analysis", "cost_analysis", "collectives", "model",
                "fits_h100_80gb"):
        assert key in rec
    ma = rec["memory_analysis"]
    assert set(ma) == {"argument_size_in_bytes", "output_size_in_bytes",
                       "temp_size_in_bytes"}
    assert set(rec["collectives"]) >= {"bytes", "counts", "total_bytes"}
    assert set(rec["collectives"]["bytes"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    cfg = get_config("llama3-8b")
    assert rec["model"] == {"params": cfg.param_count(),
                            "active_params": cfg.param_count(True),
                            "tokens_per_step": 128, "kind": "decode"}
    # the cache's rank share: 128 rows over 16, 8 KV heads whole
    cache = 2 * cfg.n_layers * (128 // 16) * 32768 * 8 * 128 * 2
    assert rec["arguments"]["cache"] == cache
    assert ma["argument_size_in_bytes"] == sum(rec["arguments"].values())
    assert rec["fits_h100_80gb"] == (
        ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        <= dryrun.H100_BYTES)
    path = tmp_path / "llama3-8b__decode_32k__single_pod_16x16.json"
    assert json.loads(path.read_text())["status"] == "ok"


def test_command_line(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    lines = capsys.readouterr().out.splitlines()
    skips = [ln for ln in lines if ln.startswith("SKIP")]
    assert len(skips) == 2 and all(
        "(skip: encoder-only arch has no decode step)" in ln for ln in skips)
    assert lines[-1] == "done; failures=0"
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                     "--mesh", "multi", "--out", str(tmp_path)])
    assert done.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("OK   mamba2-130m") and "multi" in out[1]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "hubert-xlarge__decode_32k__multi_pod_2x16x16.json",
        "hubert-xlarge__decode_32k__single_pod_16x16.json",
        "mamba2-130m__long_500k__multi_pod_2x16x16.json"]


def test_group_torn_down_and_never_replaced(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise ValueError("placement")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    rec = dryrun.run_cell("llama3-8b", "prefill_32k", True, save=False)
    assert rec["status"] == "FAIL: ValueError: placement"
    assert not dist.is_initialized()
    with dryrun.fake_group(4):
        with pytest.raises(RuntimeError, match="already live"):
            dryrun.run_cell("llama3-8b", "prefill_32k", True, save=False)
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()


def test_live_bytes_counts_what_the_program_allocates():
    """The tracker counts each new storage once (views and in-place
    results add nothing), never the arguments', frees a storage when it
    dies, and keeps the peak."""
    a = torch.zeros(256)                      # 1 KiB, an argument
    with dryrun.LiveBytes("cpu", collect_every=0) as live:
        live.known(a)
        a.add_(1)
        b = a + 1                             # +1 KiB
        c = b.view(16, 16)
        d = b * 2                             # +1 KiB: 2 KiB live
        del b, c
        e = d[:128] + 1                       # +0.5 KiB after 1 KiB freed
        f = torch.zeros(8, device="meta")     # another device: not counted
    assert (live.peak, live.live) == (2048, 1536)
    del d, e, f
    assert live.live == 0
