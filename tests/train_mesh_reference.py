"""The JAX package's side of ``test_torch_train_ranks.py``, on four forced
host devices (pytest collects nothing here).

    python tests/train_mesh_reference.py DIR

reads ``DIR/inputs.npz`` (written by the test) and writes to
``DIR/ref.npz``, for each case of ``torch_ranks.TRAIN_CASES`` on its mesh
(``torch_ranks.MESHES``): the loss and ``jax.grad`` of ``repro``'s
``loss_fn`` (float32 compute) from the carried weights, and three steps of
``repro``'s ``build_train_step`` on ``make_rules(mesh)``: each step's loss,
grad_norm and checksums, and the parameters after them; and the loss
and ``jax.grad`` of reduced llama3-8b at the vocabularies of
``torch_ranks.VOCAB_CASES`` on their meshes.
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

from repro.configs.base import TrainConfig  # noqa: E402
from repro.core.acc_state import flatten_checksums  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.steps import build_train_step  # noqa: E402
from repro.models.registry import build_model, get_config  # noqa: E402
from repro.optim import init_error_state  # noqa: E402
from repro.sharding.partition import make_rules  # noqa: E402

import torch_ranks as R  # noqa: E402


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


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def main(out_dir: str) -> None:
    assert len(jax.devices()) == R.WORLD, jax.devices()
    with np.load(os.path.join(out_dir, "inputs.npz")) as z:
        flat = {k.replace("__", "/"): z[k] for k in z.files}
    meshes = {name: make_mesh(shape, axes)
              for name, (shape, axes) in R.MESHES.items()}
    out = {}
    for arch, mesh_name, optimizer in R.TRAIN_CASES:
        mesh = meshes[mesh_name]
        cfg = R.train_cfg(get_config, arch)
        api = build_model(cfg)
        params = _tree(flat, f"{arch}/params/")

        def batch(t):
            return {k: jnp.asarray(flat[f"{arch}/batch{t}/{k}"])
                    for k in ("tokens", "labels")}

        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss_fn(p, b, mesh)))(params, batch(0))
        out[f"grads/{arch}/loss"] = loss
        for p, g in _paths(grads):
            out[f"grads/{arch}/{p}"] = g

        tcfg = R.train_tcfg(TrainConfig, optimizer)
        step, _, opt_init = build_train_step(api, tcfg, make_rules(mesh),
                                             donate=False)
        p, o, e = params, opt_init(params), init_error_state(params)
        for t in range(R.TRAIN_STEPS):
            p, o, e, m, c = step(p, o, e, batch(t), jax.random.PRNGKey(t))
            key = f"steps/{arch}/{t}"
            out[f"{key}/loss"] = m["loss"]
            out[f"{key}/grad_norm"] = m["grad_norm"]
            for k in ("params", "opt", "updates"):
                out[f"{key}/{k}"] = np.asarray(flatten_checksums(c[k]))
        for path, w in _paths(p):
            out[f"steps/{arch}/params/{path}"] = w
    for mesh_name, vocab in R.VOCAB_CASES:
        mesh = meshes[mesh_name]
        api = build_model(dataclasses.replace(
            R.train_cfg(get_config, "llama3-8b"), vocab_size=vocab))
        batch = {k: jnp.asarray(flat[f"v{vocab}/batch0/{k}"])
                 for k in ("tokens", "labels")}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss_fn(p, b, mesh)))(
            _tree(flat, "llama3-8b/params/"), batch)
        key = f"grads/{R.vocab_case(mesh_name, vocab)}"
        out[f"{key}/loss"] = loss
        for p, g in _paths(grads):
            out[f"{key}/{p}"] = g
    np.savez(os.path.join(out_dir, "ref.npz"),
             **{k.replace("/", "__"): np.asarray(v, np.float32)
                for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1])
