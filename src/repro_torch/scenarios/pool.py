"""Self-healing process pool for sharded sweeps.

``multiprocessing.Pool.imap`` — the previous ``sweep(workers=N)``
executor — has exactly the failure modes a crash-consistence harness
should not: a worker that segfaults poisons the pool, a hung worker
stalls the whole sweep forever, a ``KeyboardInterrupt`` in the parent
can strand orphan children, and an interrupted sweep restarts from cell
zero. :func:`run_sharded` replaces it with one supervised ``Process``
per shard and the same resilience loop the scenario layer studies:

* **detection** — each shard gets a wall-clock deadline; the supervisor
  multiplexes on result pipes *and* process sentinels, so a worker that
  dies (killed, segfault) or hangs (deadline exceeded) is classified
  within one poll interval;
* **retry** — failed shards are re-dispatched with exponential backoff
  (``backoff * 2**(attempt-1)``), up to ``retries`` re-runs; shard
  evaluation is deterministic, so a retry is byte-identical to a run
  that never failed;
* **graceful degradation** — when retries are exhausted (or the shard
  raised a real exception, which a retry would only repeat), an
  optional ``degrade`` hook maps the job to a cheaper equivalent, or
  declines with ``None`` (the sweep layer steps a measure shard that
  died or hung down to full, and declines for a batched shard and for a
  worker's exception), before giving up with :class:`ShardFailure`;
* **resume** — with ``journal=<path>``, every completed shard is
  appended to a jsonl journal keyed by a fingerprint of its job; a
  re-run with the same jobs preloads the completed shards and
  re-executes only the missing ones. The journal is guarded by an
  ``O_EXCL`` pid lockfile (stale locks from dead owners are taken
  over) and removed on success;
* **no orphans** — children run a parent-death watchdog thread
  (``os._exit`` the moment the parent vanishes), and the supervisor's
  ``finally`` terminates and joins every live child, so neither a
  parent ``KeyboardInterrupt`` nor a parent kill leaks processes or a
  stale journal lock.

``chaos={shard_index: "kill" | "hang"}`` injects those two failures
into a shard's *first* attempt — the test hook that proves the loop
above actually heals (tests/test_selfhealing_pool.py and the
``fig_faults --chaos`` gate).

Results come back as a list in job order regardless of completion
order, so sharded output is deterministic.
"""

from __future__ import annotations

import base64
import collections
import hashlib
import json
import multiprocessing
import multiprocessing.connection
import os
import pickle
import signal
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["ShardFailure", "job_fingerprint", "run_sharded"]

# how often the supervisor re-checks deadlines / backoff timers, and
# how often child watchdogs re-check the parent (seconds)
_POLL_SECONDS = 0.1
_WATCHDOG_SECONDS = 0.25


class ShardFailure(RuntimeError):
    """A shard exhausted every retry (and degradation, if any)."""

    def __init__(self, job_index: int, reason: str, detail: str = ""):
        self.job_index = job_index
        self.reason = reason
        self.detail = detail
        msg = f"shard {job_index} failed ({reason}) after all retries"
        if detail:
            msg += f":\n{detail}"
        super().__init__(msg)


def job_fingerprint(job) -> str:
    """Stable identity of a shard's work, for journal matching. ``repr``
    of the job tuple (registry spec strings, dataclass plans/configs) is
    deterministic across processes — unlike ``hash()``."""
    return hashlib.sha256(repr(job).encode()).hexdigest()[:16]


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _acquire_journal_lock(lock_path: str) -> None:
    """``O_CREAT | O_EXCL`` pid lockfile. A lock whose owner pid is dead
    is stale (the owner was killed before its ``finally``) and is taken
    over instead of wedging every future resume."""
    while True:
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                         0o644)
        except FileExistsError:
            try:
                with open(lock_path) as fh:
                    owner = int(fh.read().strip() or "0")
            except (OSError, ValueError):
                owner = 0
            if owner and owner != os.getpid() and _pid_alive(owner):
                raise RuntimeError(
                    f"sweep journal is locked by live pid {owner} "
                    f"({lock_path}); is another sweep writing it?")
            try:
                os.unlink(lock_path)     # stale: dead owner
            except FileNotFoundError:
                pass
            continue
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
        return


def _release_journal_lock(lock_path: str) -> None:
    try:
        os.unlink(lock_path)
    except FileNotFoundError:
        pass


def _load_journal(journal: str, jobs: Sequence) -> Dict[int, Any]:
    """Completed results from a previous interrupted run — only entries
    whose fingerprint still matches the job at that index (a changed
    matrix invalidates the cell, not the whole journal)."""
    done: Dict[int, Any] = {}
    if not os.path.exists(journal):
        return done
    prints = [job_fingerprint(j) for j in jobs]
    with open(journal) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
                idx = int(entry["job"])
                if 0 <= idx < len(jobs) and entry["fingerprint"] == prints[idx]:
                    done[idx] = pickle.loads(
                        base64.b64decode(entry["blob"]))
            except (KeyError, ValueError, pickle.UnpicklingError,
                    json.JSONDecodeError):
                continue     # torn tail of an interrupted append
    return done


def _append_journal(journal: str, idx: int, job, result) -> None:
    entry = {
        "job": idx,
        "fingerprint": job_fingerprint(job),
        "blob": base64.b64encode(pickle.dumps(result)).decode(),
    }
    with open(journal, "a") as fh:
        fh.write(json.dumps(entry) + "\n")
        fh.flush()
        os.fsync(fh.fileno())


def _watchdog() -> None:
    """Child-side parent-death watchdog: if the parent disappears (we
    get re-parented), exit immediately — no orphaned shard may keep
    burning CPU or holding the journal lock's owner alive."""
    parent = os.getppid()
    while True:
        time.sleep(_WATCHDOG_SECONDS)
        if os.getppid() != parent:
            os._exit(113)


def _shard_main(conn, worker_fn: Callable, job,
                chaos_action: Optional[str]) -> None:
    threading.Thread(target=_watchdog, daemon=True).start()
    if chaos_action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif chaos_action == "hang":
        time.sleep(3600)
    try:
        result = worker_fn(job)
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            conn.close()
        return
    conn.send(("ok", result))
    conn.close()


class _Shard:
    __slots__ = ("index", "job", "attempt", "chaos", "proc", "conn",
                 "deadline", "ready_at")

    def __init__(self, index: int, job, chaos: Optional[str]):
        self.index = index
        self.job = job
        self.attempt = 0             # completed launch attempts
        self.chaos = chaos           # injected failure, first attempt only
        self.proc = None
        self.conn = None
        self.deadline: Optional[float] = None
        self.ready_at = 0.0          # backoff gate for the next launch


def run_sharded(jobs: Sequence, worker_fn: Callable, workers: int, *,
                timeout: Optional[float] = None,
                retries: int = 2,
                backoff: float = 0.5,
                journal: Optional[str] = None,
                chaos: Optional[Dict[int, str]] = None,
                degrade: Optional[Callable] = None,
                start_method: str = "fork",
                progress_cb: Optional[Callable[[Dict[str, Any]], None]] = None
                ) -> List[Any]:
    """Run ``worker_fn(job)`` for every job across ``workers`` processes
    with the supervision loop described in the module docstring. Returns
    results in job order.

    ``degrade(job, reason) -> job | None`` maps a failed job to a
    cheaper equivalent (attempts reset); ``None`` means no fallback
    left. ``chaos[i]`` ("kill" | "hang") is injected into shard ``i``'s
    first attempt. ``progress_cb`` receives one dict per supervision
    event ({"event": "done" | "retry" | "degrade" | "resumed", ...}).
    """
    if workers < 1:
        raise ValueError("workers must be >= 1")
    results: Dict[int, Any] = {}
    lock_path = (journal + ".lock") if journal else None
    if journal:
        _acquire_journal_lock(lock_path)
    try:
        if journal:
            for idx, res in _load_journal(journal, jobs).items():
                results[idx] = res
                if progress_cb is not None:
                    progress_cb({"event": "resumed", "job": idx})
        pending = collections.deque(
            _Shard(i, job, (chaos or {}).get(i))
            for i, job in enumerate(jobs) if i not in results)
        live: List[_Shard] = []
        ctx = multiprocessing.get_context(start_method)

        def launch(shard: _Shard) -> None:
            recv, send = ctx.Pipe(duplex=False)
            shard.proc = ctx.Process(
                target=_shard_main,
                args=(send, worker_fn, shard.job,
                      shard.chaos if shard.attempt == 0 else None),
                daemon=True)
            shard.proc.start()
            send.close()             # parent keeps only the read end
            shard.conn = recv
            shard.deadline = (time.monotonic() + timeout
                              if timeout is not None else None)
            live.append(shard)

        def reap(shard: _Shard) -> None:
            live.remove(shard)
            if shard.proc.is_alive():
                shard.proc.kill()
            shard.proc.join()
            shard.conn.close()
            shard.proc = shard.conn = shard.deadline = None

        def fail(shard: _Shard, reason: str, detail: str = "") -> None:
            """Retry -> degrade -> ShardFailure. Real worker exceptions
            skip the retry ladder — re-running identical code on an
            identical job only re-raises."""
            shard.attempt += 1
            retryable = reason in ("died", "timeout")
            if retryable and shard.attempt <= retries:
                delay = backoff * (2 ** (shard.attempt - 1))
                shard.ready_at = time.monotonic() + delay
                if progress_cb is not None:
                    progress_cb({"event": "retry", "job": shard.index,
                                 "reason": reason, "attempt": shard.attempt,
                                 "delay": delay})
                pending.append(shard)
                return
            if degrade is not None:
                downgraded = degrade(shard.job, reason)
                if downgraded is not None:
                    shard.job = downgraded
                    shard.attempt = 0
                    shard.chaos = None
                    shard.ready_at = 0.0
                    if progress_cb is not None:
                        progress_cb({"event": "degrade",
                                     "job": shard.index, "reason": reason})
                    pending.append(shard)
                    return
            raise ShardFailure(shard.index, reason, detail)

        def finish(shard: _Shard, result) -> None:
            results[shard.index] = result
            if journal:
                # fingerprint the job as RUN: a degraded shard's entry
                # must not satisfy a resume that asks for the original
                _append_journal(journal, shard.index, shard.job, result)
            if progress_cb is not None:
                progress_cb({"event": "done", "job": shard.index})

        while pending or live:
            now = time.monotonic()
            # launch every backoff-ready shard into free slots
            for _ in range(len(pending)):
                if len(live) >= workers:
                    break
                shard = pending.popleft()
                if shard.ready_at > now:
                    pending.append(shard)   # still backing off
                    continue
                launch(shard)
            if not live:
                time.sleep(_POLL_SECONDS)
                continue
            waitables = []
            for shard in live:
                waitables.append(shard.conn)
                waitables.append(shard.proc.sentinel)
            ready = multiprocessing.connection.wait(
                waitables, timeout=_POLL_SECONDS)
            ready_set = set(ready)
            for shard in list(live):
                if shard.conn in ready_set:
                    try:
                        outcome, payload = shard.conn.recv()
                    except (EOFError, OSError):
                        reap(shard)
                        fail(shard, "died")
                        continue
                    reap(shard)
                    if outcome == "ok":
                        finish(shard, payload)
                    else:
                        fail(shard, "error", payload)
                elif shard.proc.sentinel in ready_set:
                    # process exited without ever sending a result
                    reap(shard)
                    fail(shard, "died")
                elif (shard.deadline is not None
                      and time.monotonic() > shard.deadline):
                    reap(shard)
                    fail(shard, "timeout")
        ordered = [results[i] for i in range(len(jobs))]
        if journal:
            # complete: the journal has served its purpose
            try:
                os.unlink(journal)
            except FileNotFoundError:
                pass
        return ordered
    finally:
        # no orphans, no stale locks — whatever got us here
        for shard in list(locals().get("live") or []):
            if shard.proc is not None and shard.proc.is_alive():
                shard.proc.kill()
            if shard.proc is not None:
                shard.proc.join()
            if shard.conn is not None:
                shard.conn.close()
        if journal:
            _release_journal_lock(lock_path)
