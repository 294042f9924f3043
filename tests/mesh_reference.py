"""The JAX package's side of ``test_torch_sharding.py``'s cases across
ranks, on four forced host devices (pytest collects nothing here).

    python tests/mesh_reference.py DIR

reads ``DIR/inputs.npz`` (written by the test) and writes every
reference output to ``DIR/ref.npz``: ``repro``'s ``moe_apply_ep`` at
the config's capacity, its tensor-parallel ``flash_sdpa``, the reduced
models' forwards and decode steps, and its four-stage GPipe schedule,
on the meshes of ``torch_ranks.MESHES``.
"""

import dataclasses
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, "src"), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import layers as L  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.models.registry import build_model, get_config  # noqa: E402
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


def main(out_dir: str) -> None:
    assert len(jax.devices()) == R.WORLD, jax.devices()
    with np.load(os.path.join(out_dir, "inputs.npz")) as z:
        flat = {k.replace("__", "/"): z[k] for k in z.files}
    meshes = {name: make_mesh(shape, axes)
              for name, (shape, axes) in R.MESHES.items()}
    out = {}

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

    mesh = meshes["2x2"]
    B, _ = R.FORWARD_SHAPE
    for arch in R.FORWARD_ARCHS:
        cfg = _f32(arch)
        api = build_model(cfg)
        params = _tree(flat, f"{arch}/params/")
        tokens = jnp.asarray(flat[f"{arch}/tokens"])
        kw = R.flash_kw(cfg)
        fwd = jax.jit(lambda p, b: api.forward(p, b, mesh, **kw))
        out[f"{arch}/forward"] = fwd(params, {"tokens": tokens})
        step = jax.jit(lambda p, c, t, pos: api.decode_step(p, c, t, pos,
                                                            mesh))
        cache, _ = api.init_cache(B, R.DECODE_STEPS + 1)
        steps = []
        for t in range(R.DECODE_STEPS):
            logits, cache = step(params, cache, tokens[:, t:t + 1],
                                 jnp.int32(t))
            steps.append(np.asarray(logits))
        out[f"{arch}/decode"] = np.stack(steps)

    W, x = jnp.asarray(flat["pipe/W"]), jnp.asarray(flat["pipe/x"])

    def stage_fn(ps, act):
        h, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), act, ps)
        return h

    out["pipe/four"] = pipeline_apply(stage_fn, stage_params(W, R.WORLD), x,
                                      make_mesh((R.WORLD,), ("stage",)))
    np.savez(os.path.join(out_dir, "ref.npz"),
             **{k.replace("/", "__"): np.asarray(v, np.float32)
                for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1])
