"""What every cell shares: finding its files by name, the run's
description, comparisons against limits, the per-layer readers, the
check for forbidden modules, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<config>.json``)
and a traffic mix (``traffic/<traffic>.json``); its limits are
``limits/<cell>.json`` and each per-layer metric's reader is
``metrics/<metric>.py``. The traffic file's ``driver`` names the module
under ``drivers/`` that runs it and refuses a key that nothing reads.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find_cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    cell: Dict
    config: Dict          # configs/<config>.json
    traffic: Dict         # traffic/<traffic>.json
    limits: Dict          # limits/<cell>.json
    seed: int
    seconds: float
    trace: bool
    t0: float             # the process's start, on perf_counter
    device: object = None
    port_cfg: object = None
    fault: Optional[str] = None   # tests and readings only: a planted fault

    @property
    def model(self) -> Dict:
        return self.config["model"]


def load_run(cell_name: str, seed: int, seconds: float, trace: bool,
             t0: float, bench: Optional[Dict] = None) -> Run:
    bench = bench or benchmark()
    cell = find_cell(bench, cell_name)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, config["file"])) as fh:
        cfg = json.load(fh)
    traffic = load_json("traffic", cell["traffic"] + ".json")
    importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").check(traffic)
    return Run(cell=cell, config=cfg, traffic=traffic,
               limits=load_json("limits", cell_name + ".json"),
               seed=seed, seconds=seconds, trace=trace, t0=t0)


def check_port_config(model: Dict, cfg) -> None:
    """The program's ModelConfig has every size the configuration file
    states (``padded_vocab`` as it resolves it)."""
    got = {"padded_vocab": cfg.padded_vocab}
    for k, want in model.items():
        have = got[k] if k in got else getattr(cfg, k)
        if have != want:
            raise ValueError(f"{cfg.name}: {k} is {have!r} in the program, "
                             f"{want!r} in the configuration file")


def port_config(run: Run):
    """The program's configuration of the run's arch, checked against the
    configuration file."""
    from repro_torch.models.registry import get_config
    cfg = get_config(run.config["arch"])
    check_port_config(run.model, cfg)
    return cfg


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              floor_share: float = 1e-3) -> List[float]:
    """|prog - ref| / max(ref, median ref) of each leaf, for norms keyed by
    leaf; leaves whose reference norm is under ``floor_share`` of the
    median leaf's are left out (nought to rounding in the reference). A
    leaf missing or not finite on the program's side reads infinity."""
    med = statistics.median(ref.values())
    out = []
    for n, r in ref.items():
        if r < floor_share * med:
            continue
        p = prog.get(n)
        out.append(math.inf if p is None or not math.isfinite(p)
                   else abs(p - r) / max(r, med))
    return out


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    return max(leaf_gaps(prog, ref))


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    gaps = leaf_gaps(prog, ref)
    return math.inf if math.inf in gaps else statistics.median(gaps)


def checks_block(values: Dict[str, float], limits: Dict) -> Dict:
    """{name: {"value", "limit"}} in the limits file's order."""
    out = {}
    for name, lim in limits["limits"].items():
        v = values.get(name, math.inf)
        out[name] = {"value": v, "limit": lim}
    return out


def passes(checks: Dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


# ---------------------------------------------------------------------------
# per-layer readers
# ---------------------------------------------------------------------------

def metrics_of(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The cell's end-to-end (``kind`` "end_to_end") or per-layer metrics."""
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or any(
                e["name"] == m["moves"] and cell in e.get("workloads", [cell])
                for e in bench["end_to_end"]):
            out.append(m)
    return out


def read_metric(name: str, ctx: Dict) -> Optional[float]:
    """The value that ``metrics/<name>.py``'s ``read(ctx)`` gives, or None
    where it finds nothing to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def peak_of(kind: str) -> Optional[Dict]:
    """The card's published peaks (``peaks.json``), or None for a card
    that the table lacks."""
    return load_json("peaks.json").get(kind)


# ---------------------------------------------------------------------------
# the end of a run
# ---------------------------------------------------------------------------

def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, checks: Dict,
                breakdown: Optional[Dict] = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: Dict) -> str:
    return "\n".join(f"check {n} {c['value']!r} limit {c['limit']!r}"
                     for n, c in checks.items())
