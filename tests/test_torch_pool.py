"""Port vs reference, the self-healing shard pool
(``repro_torch.scenarios.pool`` against ``repro.scenarios.pool``): the
journal that lets an interrupted sharded sweep resume, and its lock.

Each case runs through both packages' ``run_sharded`` and must give the
same observations — the results, which shards ran (marker files the
workers drop), the ``resumed`` events, the journal consumed on success
and the lock released — as ``tests/test_selfhealing_pool.py`` holds the
reference to them. A journal written by one package resumes in the
other: the job fingerprints and the journal lines are the same.
"""

import multiprocessing
import os
import time

import pytest

import repro.scenarios.pool as ref_pool
import repro_torch.scenarios.pool as port_pool

POOLS = {"repro": ref_pool, "port": port_pool}


def square(job):
    return job * job


def marking_square(job):
    """job = (value, marker_dir, flag_dir): drops ``ran-<value>`` so the
    parent sees which shards executed; fails on value 3 unless the
    ``allow`` file exists."""
    value, marker_dir, flag_dir = job
    with open(os.path.join(marker_dir, f"ran-{value}"), "w"):
        pass
    if value == 3 and not os.path.exists(os.path.join(flag_dir, "allow")):
        raise ValueError("shard 3 not allowed yet")
    return value * value


def _ran(d) -> set:
    return {f for f in os.listdir(str(d)) if f.startswith("ran-")}


def _interrupted(pool, tmp_path, journal):
    """A sharded run whose shard 3 fails: the journal keeps shards 0-2.
    Returns the jobs; the markers are cleared."""
    jobs = [(i, str(tmp_path), str(tmp_path)) for i in range(4)]
    with pytest.raises(pool.ShardFailure):
        pool.run_sharded(jobs, marking_square, 2, retries=0,
                         journal=journal)
    assert os.path.exists(journal)
    assert not os.path.exists(journal + ".lock")
    assert _ran(tmp_path) == {"ran-0", "ran-1", "ran-2", "ran-3"}
    for f in _ran(tmp_path):
        os.unlink(str(tmp_path / f))
    return jobs


def _resume(pool, tmp_path, journal, jobs, **kw):
    with open(str(tmp_path / "allow"), "w"):
        pass
    events = []
    got = pool.run_sharded(jobs, marking_square, 2, retries=0,
                           journal=journal, progress_cb=events.append, **kw)
    return {"results": got, "ran": _ran(tmp_path),
            "resumed": sorted(e["job"] for e in events
                              if e["event"] == "resumed"),
            "journal_left": os.path.exists(journal),
            "lock_left": os.path.exists(journal + ".lock")}


RESUMED = {"results": [0, 1, 4, 9], "ran": {"ran-3"}, "resumed": [0, 1, 2],
           "journal_left": False, "lock_left": False}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_resume_reexecutes_only_missing_shards(tmp_path, name):
    pool = POOLS[name]
    journal = str(tmp_path / "sweep.jsonl")
    jobs = _interrupted(pool, tmp_path, journal)
    assert _resume(pool, tmp_path, journal, jobs) == RESUMED


@pytest.mark.parametrize("writer,reader", [("repro", "port"),
                                           ("port", "repro")])
def test_journal_resumes_across_packages(tmp_path, writer, reader):
    """One package's partial journal, resumed by the other: only the
    missing shard runs."""
    journal = str(tmp_path / "sweep.jsonl")
    jobs = _interrupted(POOLS[writer], tmp_path, journal)
    assert _resume(POOLS[reader], tmp_path, journal, jobs) == RESUMED


def test_resume_in_spawned_shards(tmp_path):
    """The port's pool resumes alike with spawned shards (the start
    method its batched sweeps use)."""
    journal = str(tmp_path / "sweep.jsonl")
    jobs = _interrupted(port_pool, tmp_path, journal)
    assert _resume(port_pool, tmp_path, journal, jobs,
                   start_method="spawn") == RESUMED


@pytest.mark.parametrize("job", [0, 7, (1, "a", "b"), ("cg", {"n": 8}),
                                 [1.5, None]])
def test_job_fingerprints_equal(job):
    assert port_pool.job_fingerprint(job) == ref_pool.job_fingerprint(job)


@pytest.mark.parametrize("name", sorted(POOLS))
def test_changed_job_invalidates_its_entry_only(tmp_path, name):
    pool = POOLS[name]
    journal = str(tmp_path / "sweep.jsonl")
    assert pool.run_sharded([0, 1, 2], square, 2, journal=journal) \
        == [0, 1, 4]
    assert not os.path.exists(journal)
    assert pool.run_sharded([0, 1, 5], square, 2, journal=journal) \
        == [0, 1, 25]


@pytest.mark.parametrize("name", sorted(POOLS))
def test_live_lock_owner_blocks(tmp_path, name):
    pool = POOLS[name]
    proc = multiprocessing.Process(target=time.sleep, args=(30,))
    proc.start()
    journal = str(tmp_path / "sweep.jsonl")
    try:
        with open(journal + ".lock", "w") as fh:
            fh.write(str(proc.pid))
        with pytest.raises(RuntimeError, match="locked by live pid"):
            pool.run_sharded([1], square, 1, journal=journal)
    finally:
        proc.terminate()
        proc.join()
        os.unlink(journal + ".lock")


@pytest.mark.parametrize("name", sorted(POOLS))
def test_stale_lock_from_dead_owner_is_taken_over(tmp_path, name):
    pool = POOLS[name]
    proc = multiprocessing.Process(target=square, args=(0,))
    proc.start()
    proc.join()
    journal = str(tmp_path / "sweep.jsonl")
    with open(journal + ".lock", "w") as fh:
        fh.write(str(proc.pid))
    assert pool.run_sharded([2], square, 1, journal=journal) == [4]
    assert not os.path.exists(journal + ".lock")
