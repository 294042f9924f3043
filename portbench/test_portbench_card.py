"""On the card only (skips elsewhere): the control at each cell's own
size fails the cell's limits while the program passes them, on three
seeds. The control is the plain reference with float8 e4m3 products put
in the program's place, compared with the float32 reference as the
program is; ``readings.py`` takes the same readings for a dozen seeds.

    python3 -m pytest -q portbench/test_portbench_card.py
"""

import pytest

from portbench import bench

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]
SEEDS = (9001, 9002, 9003)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    import importlib
    import time
    import torch
    from portbench import readings, run as RUN
    RUN.setup_env()
    torch.zeros(1, device=card)
    for seed in SEEDS:
        r = bench.load_run(cell, seed, 2.0, False, time.perf_counter())
        r.device = card
        r.port_cfg = bench.port_config(r)
        drv = importlib.import_module(
            f"portbench.drivers.{r.traffic['driver']}")
        res = drv.run(r)
        assert bench.passes(res["checks"]), res["checks"]
        ctl = readings.train_control(r)
        ctl.pop("_runs", None)
        lim = {"limits": {n: r.limits["limits"][n] for n in ctl
                          if n in r.limits["limits"]}}
        assert not bench.passes(bench.checks_block(ctl, lim)), ctl
        del res
        torch.cuda.empty_cache()
