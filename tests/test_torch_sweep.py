"""Port vs reference, the ported path as a whole: ``repro_torch.scenarios.
sweep(engine="fork", mode="batched")`` on the torn-crash figure's smoke
matrix must equal ``repro.scenarios.sweep(mode="measure")`` cell for
cell — the reference's own identity contract for batched cells — on
every field of ``deterministic_cell_dict`` except ``state_certified``
(fork/measure-only). Equality is exact: the certainty band sends every
borderline device verdict to the exact host code.

On the CPU the port's wrappers take the plain versions of the CUDA
kernels; the tests check that they did, and that nothing was launched.

Also here: the import guard (the port imports neither jax nor repro).
"""

import os
import re
import subprocess
import sys

import pytest
import torch

import repro.core.nvm as ref_nvm
import repro.scenarios as ref_sc
import repro_torch
import repro_torch.core.nvm as port_nvm
import repro_torch.scenarios as port_sc
from repro_torch.core.backends import batched
from repro_torch.kernels.abft_matmul import kernel as mm_kernel
from repro_torch.kernels.abft_matmul import ops as mm_ops
from repro_torch.kernels.checksum_verify import kernel as cv_kernel
from repro_torch.kernels.checksum_verify import ops as cv_ops
from repro_torch.scenarios import batched_engine

# benchmarks/fig_torn.py, smoke size
SEED = 23
FRACTIONS = (0.0, 0.5, 1.0)
SAMPLES = 2
WORKLOADS = {
    "cg": ("cg", {"n": 512, "iters": 8, "seed": 5}),
    "mm": ("mm", {"n": 32, "k": 8, "seed": 2}),
    "xsbench": ("xsbench", {"lookups": 80, "grid_points": 600,
                            "n_nuclides": 8, "n_materials": 6,
                            "max_nuclides_per_material": 4,
                            "flush_every_frac": 0.1, "seed": 7}),
}
STRATEGIES = ("adcc", "undo_log", "checkpoint_nvm@2")

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _plans(sc):
    dense = tuple(
        sc.CrashPlan.at_every_step(
            torn=sc.TornSpec(fraction=f, seed=SEED, mode="random",
                             samples=SAMPLES))
        for f in FRACTIONS)
    evict = (sc.CrashPlan.at_every_step(
        torn=sc.TornSpec(fraction=0.5, seed=SEED, mode="eviction")),)
    return (sc.CrashPlan.no_crash(),) + dense + evict


def _sweep(sc, nvm, name, mode, **kw):
    return sc.sweep([WORKLOADS[name]], STRATEGIES, _plans(sc),
                    cfg=nvm.NVMConfig(cache_bytes=1024 * 1024),
                    engine="fork", mode=mode, **kw)


def _cells(sc, results):
    out = []
    for r in results:
        d = sc.deterministic_cell_dict(r)
        d.pop("state_certified", None)
        out.append(d)
    return out


_reference_cache = {}


def _reference_measure(name):
    """``repro``'s measure-mode cells of one workload's matrix: the
    oracle, computed once per process."""
    if name not in _reference_cache:
        _reference_cache[name] = _cells(
            ref_sc, _sweep(ref_sc, ref_nvm, name, "measure"))
    return _reference_cache[name]


@pytest.fixture(autouse=True)
def cpu():
    with repro_torch.use_device("cpu"):
        yield
    assert mm_kernel.launches == 0 and cv_kernel.launches == 0


@pytest.fixture
def plain_calls(monkeypatch):
    """Count the calls that reach the kernels' plain versions."""
    calls = {"abft_matmul": 0, "tile_sums": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(mm_ops, "abft_matmul_plain",
                        counting("abft_matmul", mm_ops.abft_matmul_plain))
    monkeypatch.setattr(cv_ops, "tile_sums_plain",
                        counting("tile_sums", cv_ops.tile_sums_plain))
    return calls


def _assert_identical(name, got_results):
    got = _cells(port_sc, got_results)
    want = _reference_measure(name)
    assert len(got) == len(want) > 50
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name} cell {i} ({w['plan']}, step {w['crash_step']})"


@pytest.mark.parametrize("name", ["cg", "mm", "xsbench"])
def test_batched_equals_reference_measure(name, plain_calls):
    batched_engine.reset_stats()
    results = _sweep(port_sc, port_nvm, name, "batched")
    _assert_identical(name, results)
    adcc = [r for r in results if r.strategy == "adcc"]
    assert adcc and not any("batched_fallback" in r.info for r in results)
    # on the CPU: the sparse CG route (no product kernel involved) and
    # the plain tile sums
    assert batched.cg_route() == "sparse"
    assert plain_calls["abft_matmul"] == 0
    stats = batched_engine.stats
    if name == "cg":
        assert stats["cg_waves"] > 0 and stats["cg_candidates"] > 0
    if name == "mm":
        assert plain_calls["tile_sums"] > 0 and stats["mm_chunks"] > 0


def test_batched_dense_route_equals_reference_measure(monkeypatch,
                                                      plain_calls):
    """The card's route, on the CPU: the dense operator through
    ``gemm_batch``, whose plain version stands in for the kernel."""
    monkeypatch.setattr(batched, "cg_route", lambda: "dense")
    results = _sweep(port_sc, port_nvm, "cg", "batched")
    _assert_identical("cg", results)
    assert not any("batched_fallback" in r.info for r in results)
    assert plain_calls["abft_matmul"] > 0


def test_port_measure_equals_reference_measure():
    _assert_identical("mm", _sweep(port_sc, port_nvm, "mm", "measure"))


def test_dense_route_beyond_gemm_max_n_falls_back(monkeypatch):
    monkeypatch.setattr(batched, "cg_route", lambda: "dense")
    monkeypatch.setattr(batched, "GEMM_MAX_N", 256)
    results = _sweep(port_sc, port_nvm, "cg", "batched")
    _assert_identical("cg", results)
    reasons = {r.info.get("batched_fallback") for r in results
               if r.strategy == "adcc" and r.crash_step is not None}
    assert reasons == {"cg-too-large"}
    assert not any("batched_fallback" in r.info for r in results
                   if r.strategy != "adcc")


def test_sharded_sweep_equals_serial():
    """Batched shards are spawned (a forked child can use neither the
    parent's CUDA context nor its intra-op thread pool) and inherit the
    parent's device selection; on the CPU their workers report that they
    launched no kernel."""
    import repro_torch.scenarios.driver as port_driver
    serial = _cells(port_sc, _sweep(port_sc, port_nvm, "mm", "batched"))
    sharded = _cells(port_sc, _sweep(port_sc, port_nvm, "mm", "batched",
                                     workers=2, shard_timeout=120.0,
                                     shard_retries=0))
    assert sharded == serial == _reference_measure("mm")
    assert port_driver.shard_launches == {"abft_matmul": 0, "tile_sums": 0}


@pytest.mark.parametrize("mode,reason,want", [
    ("batched", "died", None), ("batched", "timeout", None),
    ("batched", "error", None), ("measure", "error", None),
    ("measure", "died", "full"), ("measure", "timeout", "full"),
    ("full", "died", None)])
def test_degrade_never_hides_a_batched_shard_or_an_exception(mode, reason,
                                                             want):
    """A batched shard stepped down to measure would return the same
    cells, unmarked, without the kernels: it must fail instead."""
    import repro_torch.scenarios.driver as port_driver
    job = (WORKLOADS["mm"], "adcc", (), None, "fork", mode,
           {"shard": (0, 2)})
    got = port_driver._degrade_job(job, reason)
    if want is None:
        assert got is None
    else:
        assert got == job[:5] + (want,) + job[6:]


def test_failing_batched_shard_fails_the_sweep():
    from repro_torch.scenarios.pool import ShardFailure
    with pytest.raises(ShardFailure):
        _sweep(port_sc, port_nvm, "mm", "batched", workers=2,
               shard_timeout=120.0, shard_retries=0, chaos={0: "kill"})


# ---------------------------------------------------------------------------
# device selection
# ---------------------------------------------------------------------------

def test_default_device_is_the_card_and_never_the_cpu_by_itself():
    assert repro_torch.get_device() == torch.device("cpu")   # the fixture
    with repro_torch.use_device("cpu"):
        with repro_torch.use_device(torch.device("cpu")):
            assert repro_torch.get_device().type == "cpu"
    from repro_torch import device as device_mod
    saved, device_mod._selected = device_mod._selected, None
    try:
        if torch.cuda.is_available():
            assert repro_torch.get_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="use_device"):
                repro_torch.get_device()
            with pytest.raises(RuntimeError, match="no CUDA card"):
                with repro_torch.use_device("cuda"):
                    pass
    finally:
        device_mod._selected = saved
    assert batched.cuda_runtime_live() == torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# import guard
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))", re.M)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(base, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_port_imports_neither_jax_nor_repro():
    files = _port_sources()
    assert len(files) > 30
    for path in files:
        with open(path, encoding="utf-8") as fh:
            hit = _FORBIDDEN.search(fh.read())
        assert hit is None, f"{path}: {hit.group(0).strip()!r}"
    assert _FORBIDDEN.search("import repro.core") \
        and _FORBIDDEN.search("  from jax import numpy") \
        and not _FORBIDDEN.search("import repro_torch.core")


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.scenarios, repro_torch.core\n"
        "import repro_torch.algorithms, repro_torch.scenarios.carry\n"
        "import repro_torch.scenarios.batched_engine\n"
        "import repro_torch.core.backends.batched\n"
        "import repro_torch.kernels.abft_matmul.ops\n"
        "import repro_torch.kernels.checksum_verify.ops\n"
        "import repro_torch.kernels.abft_matmul.ref\n"
        "import repro_torch.kernels.checksum_verify.ref\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'jaxlib'"
        " for m, v in sys.modules.items() if v is not None)\n"
        "print('imported')\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"
