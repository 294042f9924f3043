#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port (``repro_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's number of CUDA
cards. The cell (``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; the traffic file's driver
(``portbench/drivers/``) builds the program from the seed, warms up,
measures for ``--seconds``, and checks what the window produced against
the plain reference (``portbench/reference/``). The last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics: those of the clocks and the program's timings read
from the same untraced window, those of the device from a profiled
stretch after it), ``device``
and, last, ``checks``: each compared number beside its limit, which also
make the last lines of standard error. Exits with code 2, printing no
result, where there is no CUDA card or fewer than the cell needs; with
code 3 where a module of JAX or of the JAX package ``repro`` was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def setup_path() -> None:
    """The benchmark and the program's packages on the path."""
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def setup_env() -> None:
    """Caches of any compiler inside the checkout, at fixed paths;
    cuBLAS's fixed workspace, which the trainer's deterministic
    algorithms need before the first cuBLAS call; the path."""
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    setup_path()


def execute(run, kind: str, bench_json=None):
    """Run ``run`` (its device and program configuration set) through its
    driver: (result line, lines for standard error)."""
    from portbench import bench
    bj = bench_json or bench.benchmark()
    driver = importlib.import_module(
        f"portbench.drivers.{run.traffic['driver']}")
    res = driver.run(run)
    gc.collect()
    err = [f"{k} {v!r}" for k, v in res.items()
           if k not in ("e2e", "ctx", "checks", "leaf_norms")]
    name = run.cell["name"]
    metrics = {}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": kind, "count": run.cell["chips"],
              "memory_peak_bytes": res["peak"]}
    breakdown = None
    if run.trace:
        ctx = res["ctx"]
        ctx["peak"] = bench.peak_of(kind)
        for m in bench.metrics_of(bj, name, "per_layer"):
            v = bench.read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = ctx["trace"]
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(10),
                     "idle_gaps": tr.idle_gaps(10)}
    else:
        for m in bench.metrics_of(bj, name, "end_to_end"):
            metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                  "unit": m["unit"]}
    correct = bench.passes(res["checks"]) and res["failed"] == 0
    line = bench.result_line(correct, res["attempted"], res["failed"],
                             metrics, device, res["checks"], breakdown)
    return line, err + [bench.checks_text(res["checks"])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_env()
    from portbench import bench
    run = bench.load_run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T0)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < run.cell["chips"]:
        print(f"{args.workload} needs {run.cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run.device = torch.device("cuda", 0)
    run.port_cfg = bench.port_config(run)
    line, err = execute(run, torch.cuda.get_device_name(run.device))
    # what the program loaded in this process, once the window has closed
    bad = bench.forbidden_loaded()
    if bad:
        print(f"modules of JAX or of the JAX package loaded: {bad}",
              file=sys.stderr, flush=True)
        return 3
    print("\n".join(err), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
