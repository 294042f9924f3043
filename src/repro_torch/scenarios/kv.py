"""Persistent KV-serving workload family (beyond-paper subsystem).

The paper's three workloads are batch HPC kernels; production NVM is
dominated by key-value serving. :class:`KVWorkload` runs an NVM-backed
KV store — a linear-probing hash index over version-pair slot lines
plus append-only value-log extents, all living in
:class:`~repro_torch.core.nvm.CrashEmulator` regions — through a seeded
zipfian get/put/delete request stream (Facebook ETC/UDB-style profiles:
configurable key-space size, op mix, value-size distribution, skew).
One request is one step, so the whole sweep stack — fork snapshots,
measure mode, torn ``LineSurvival`` images, ``workers=N`` sharding —
applies per-request crash points unchanged.

Store layout (everything in regions; no host-side mutable state, so
fork snapshots capture the complete store):

  kv.index   (2*n_slots, 8) int64 — slot ``s`` owns rows ``2s``/``2s+1``,
             an A/B *version pair*: an update writes the inactive row
             (readers pick the max-seq row), so the previous committed
             version of a key is never overwritten in place — the
             paper's versioned-iterates idiom applied to an index line.
             Row words: [key+1, seq, goff, nwords, value_cksum, 0, 0,
             row_cksum]; one row = one 64 B cache line.
  kv.vlog<e> (extent_words,) int64 × n_extents — segmented append-only
             value log; values never span extents (the tail waste is
             tracked). Segmentation keeps cold extents byte-stable,
             which is what the shadow-snapshot strategy's copy-on-write
             sharing exploits.
  kv.meta    (2, 16) int64 — A/B version pair of the store root:
             [head, committed, puts, dels, gets, hits, wasted,
             slot_row+1, slot_row_cksum, 0 .. 0, row_cksum]; request
             ``i`` reads the row with ``committed == i`` and writes the
             other. Words 7-8 are the *commit record*: which index row
             this request wrote and that row's checksum — recovery may
             trust a committed count only if the fingerprinted row
             survived intact (a root that outlives its write-set must
             not be adopted).

Requests are pure functions of (seed, i) via SplitMix64 — no live RNG —
so forked tails replay exactly (the sweep-engine determinism contract).

Durability semantics: the serving layer acknowledges a request when its
step completes (boundary crash => the crashed step was acked; torn
crash => it was in flight, unacked). :meth:`KVWorkload.audit_recovery`
replays the request oracle host-side and checks the *recovered* store
against the acknowledged prefix — acked updates missing/stale =>
``durability_violations``, reader-visible torn state =>
``atomicity_violations`` — which ``classify_recovery`` maps to the
serving-side correctness classes.

Under the ``adcc`` strategy the workload persists algorithm-directedly:
``adcc_after_step`` flushes exactly the lines request ``i`` touched
(value span + slot line + meta line), and ``adcc_recover`` mounts the
surviving NVM image. ``policy="validate"`` (default) checksums every
slot/value against the recovered root and drops torn entries (falling
back to the previous version row); ``policy="blind"`` trusts the image
as-is — the WITCHER-style buggy recovery that leaves partially-applied
values reader-visible (``atomicity_violation`` cells).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.nvm import CrashEmulator, NVMConfig
from . import costmodel
from .workloads import (FinalReport, RecoveryResult, Workload,
                        register_workload)

__all__ = [
    "KVProfile",
    "KV_PROFILES",
    "KVWorkload",
]

_U = np.uint64
_MASK64 = (1 << 64) - 1
_MASK63 = (1 << 63) - 1
_META_W = 16                      # meta row width (words); cksum is last


def _splitmix(x: int) -> int:
    """SplitMix64 of an arbitrary python int (counter-based randomness —
    the same idiom XSBench's lookup sampling uses)."""
    with np.errstate(over="ignore"):
        z = _U(x & _MASK64) + _U(0x9E3779B97F4A7C15)
        z = (z ^ (z >> _U(30))) * _U(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U(27))) * _U(0x94D049BB133111EB)
        z = z ^ (z >> _U(31))
    return int(z)


def _u01(x: int) -> float:
    """Deterministic uniform in [0, 1) from a 64-bit hash."""
    return (x >> 11) * (1.0 / (1 << 53))


def _mix_words(words) -> int:
    """Order-sensitive 63-bit checksum of a word sequence (fits int64)."""
    acc = 0x243F6A8885A308D3
    for w in np.asarray(words, dtype=np.int64).tolist():
        acc = _splitmix(acc ^ (w & _MASK64))
    return acc & _MASK63


def _value_words(key: int, seq: int, nwords: int) -> np.ndarray:
    """The value bytes of (key, seq): recomputable by the oracle, so a
    torn value is detectable by direct comparison."""
    base = _splitmix((key << 21) ^ seq)
    out = np.empty(nwords, dtype=np.int64)
    for j in range(nwords):
        out[j] = _splitmix(base + j) & _MASK63
    return out


@dataclasses.dataclass(frozen=True)
class KVProfile:
    """One request-stream shape (ETC/UDB-style trace profile)."""

    get_frac: float
    put_frac: float
    delete_frac: float
    # ((words, weight), ...) — value-size distribution in 8-byte words
    value_words: Tuple[Tuple[int, float], ...]
    skew: float                      # zipfian exponent over the key space

    def avg_value_words(self) -> float:
        tot = sum(p for _, p in self.value_words)
        return sum(w * p for w, p in self.value_words) / tot


KV_PROFILES: Dict[str, KVProfile] = {
    # Facebook ETC-style: read-dominated cache traffic, small values,
    # heavy skew
    "etc": KVProfile(get_frac=0.85, put_frac=0.13, delete_frac=0.02,
                     value_words=((4, 0.55), (8, 0.35), (16, 0.10)),
                     skew=0.99),
    # Facebook UDB-style: write-heavy database cache, larger values,
    # milder skew
    "udb": KVProfile(get_frac=0.58, put_frac=0.40, delete_frac=0.02,
                     value_words=((8, 0.60), (16, 0.30), (24, 0.10)),
                     skew=0.80),
}


class KVWorkload(Workload):
    """NVM-backed KV store driven by a zipfian request stream."""

    name = "kv"

    def __init__(self, profile: str = "etc", n_steps: int = 36,
                 n_keys: int = 40, seed: int = 11,
                 n_slots: Optional[int] = None,
                 n_extents: Optional[int] = None, extent_words: int = 256,
                 policy: str = "validate"):
        super().__init__()
        if profile not in KV_PROFILES:
            raise KeyError(f"unknown KV profile {profile!r} "
                           f"(available: {sorted(KV_PROFILES)})")
        if policy not in ("validate", "blind"):
            raise ValueError(f"unknown KV recovery policy {policy!r} "
                             "(choose 'validate' or 'blind')")
        self.profile = profile
        self._prof = KV_PROFILES[profile]
        self._n_steps = int(n_steps)
        self.n_keys = int(n_keys)
        self.seed = int(seed)
        self.policy = policy
        self.n_slots = int(n_slots) if n_slots is not None else 2 * self.n_keys
        if self.n_slots < self.n_keys:
            raise ValueError("n_slots must be >= n_keys (open addressing "
                             "needs a free slot per key)")
        self.extent_words = int(extent_words)
        maxw = max(w for w, _ in self._prof.value_words)
        if self.extent_words < maxw:
            raise ValueError("extent_words must fit the largest value")
        if n_extents is None:
            # worst case every request is a max-size put, plus one spare
            # extent for tail waste
            need = self._n_steps * maxw
            n_extents = -(-need // self.extent_words) + 1
        self.n_extents = int(n_extents)
        # zipfian CDF over key ranks + value-size CDF (precomputed once;
        # request generation is pure lookup)
        ranks = np.arange(1, self.n_keys + 1, dtype=np.float64)
        w = ranks ** -self._prof.skew
        self._key_cdf = np.cumsum(w) / w.sum()
        sizes = [s for s, _ in self._prof.value_words]
        wts = np.array([p for _, p in self._prof.value_words], np.float64)
        self._val_sizes = sizes
        self._val_cdf = np.cumsum(wts) / wts.sum()
        self._oracle_cache = None
        self._touched: List[Tuple[str, int, int]] = []

    def params(self):
        return {"profile": self.profile, "n_steps": self._n_steps,
                "n_keys": self.n_keys, "seed": self.seed,
                "policy": self.policy}

    # -- lifecycle -------------------------------------------------------------
    def setup(self, cfg, mode):
        self._check_mode(mode)
        self.mode = mode
        self._emu = CrashEmulator(cfg or NVMConfig())
        emu = self._emu
        self._rindex = emu.alloc("kv.index", (2 * self.n_slots, 8), np.int64)
        self._rvlog = [emu.alloc(f"kv.vlog{e}", (self.extent_words,),
                                 np.int64)
                       for e in range(self.n_extents)]
        self._rmeta = emu.alloc("kv.meta", (2, _META_W), np.int64)
        self._write_initial_meta()
        # the rest of the image is all-zero, matching freshly-allocated
        # truth; only the nonzero root row needs to reach NVM
        self._rmeta.flush()

    @property
    def emu(self):
        return self._emu

    @property
    def n_steps(self):
        return self._n_steps

    def _write_initial_meta(self):
        row = np.zeros(_META_W, np.int64)
        row[-1] = _mix_words(row[:-1])
        self._rmeta[0] = row

    def reset(self):
        self._rindex[...] = 0
        for r in self._rvlog:
            r[...] = 0
        self._rmeta[...] = 0
        self._write_initial_meta()

    # -- request stream ----------------------------------------------------------
    def _request(self, i: int) -> Tuple[str, int, int]:
        """(op, key, value_words) of request ``i`` — pure in (seed, i)."""
        base = (self.seed << 20) ^ (i * 3)
        op_u = _u01(_splitmix(base))
        key_u = _u01(_splitmix(base + 1))
        val_u = _u01(_splitmix(base + 2))
        p = self._prof
        if op_u < p.get_frac:
            op = "get"
        elif op_u < p.get_frac + p.put_frac:
            op = "put"
        else:
            op = "delete"
        key = min(int(np.searchsorted(self._key_cdf, key_u, side="right")),
                  self.n_keys - 1)
        nv = min(int(np.searchsorted(self._val_cdf, val_u, side="right")),
                 len(self._val_sizes) - 1)
        return op, key, self._val_sizes[nv]

    # -- store primitives --------------------------------------------------------
    def _meta_cur(self, i: int) -> Tuple[int, np.ndarray]:
        """(row index, row copy) of the meta row for step ``i`` —
        ``committed == i``, checksum-valid rows preferred (after a
        non-validating recovery a torn row can carry the matching
        committed word; reading it is exactly the blind policy's bug)."""
        m = self._rmeta[...]
        fallback = None
        for v in (0, 1):
            if int(m[v, 1]) != i:
                continue
            if int(m[v, -1]) == _mix_words(m[v, :-1]):
                return v, m[v].copy()
            if fallback is None:
                fallback = v
        if fallback is not None:
            return fallback, m[fallback].copy()
        raise RuntimeError(f"kv.meta has no row for request {i}")

    def _probe_start(self, key: int) -> int:
        return _splitmix(key + 0x51ED2705) % self.n_slots

    def _slot_lookup(self, key: int) -> Tuple[int, np.ndarray, bool]:
        """Linear-probe for ``key``: (slot, row-pair copy, found). Stops
        at the key's slot or the first never-claimed slot. Tombstones
        keep their key word, so probe chains stay stable across
        deletes."""
        start = self._probe_start(key)
        for t in range(self.n_slots):
            s = (start + t) % self.n_slots
            rows = self._rindex[2 * s:2 * s + 2].copy()
            k0, k1 = int(rows[0, 0]), int(rows[1, 0])
            if k0 == key + 1 or k1 == key + 1:
                return s, rows, True
            if k0 == 0 and k1 == 0:
                return s, rows, False
        raise RuntimeError("kv.index is full")

    @staticmethod
    def _active_row(rows: np.ndarray) -> Optional[int]:
        """Reader-visible version of a slot: max-seq nonempty row — no
        validation (that is a recovery-policy decision, not a read-path
        one)."""
        best = None
        for v in (0, 1):
            if int(rows[v, 0]) == 0:
                continue
            if best is None or int(rows[v, 1]) > int(rows[best, 1]):
                best = v
        return best

    def _alloc_span(self, head: int, nwords: int) -> Tuple[int, int, int, int]:
        """(aligned_head, extent, offset, waste) for an append of
        ``nwords`` — values never span extents."""
        e, off = divmod(head, self.extent_words)
        waste = 0
        if off + nwords > self.extent_words:
            waste = self.extent_words - off
            head += waste
            e, off = divmod(head, self.extent_words)
        if e >= self.n_extents:
            raise RuntimeError("kv value log exhausted — size n_extents up")
        return head, e, off, waste

    def _read_value(self, goff: int, nw: int) -> None:
        """Charged read of a value span; bounds-clipped because a
        non-validating recovery can leave a mixed (goff, nwords) pair."""
        e, off = divmod(int(goff), self.extent_words)
        if 0 <= e < self.n_extents and 0 <= off < self.extent_words:
            hi = min(off + int(nw), self.extent_words)
            if hi > off:
                self._rvlog[e][off:hi]

    # -- the step ----------------------------------------------------------------
    def step(self, i):
        op, key, nwords = self._request(i)
        cur_idx, m = self._meta_cur(i)
        head, puts, dels, gets, hits, wasted = (
            int(m[0]), int(m[2]), int(m[3]), int(m[4]), int(m[5]), int(m[6]))
        touched: List[Tuple[str, int, int]] = []
        commit_row = commit_rowck = 0      # index-row fingerprint (gets: none)
        if op == "get":
            gets += 1
            _s, rows, found = self._slot_lookup(key)
            av = self._active_row(rows)
            if found and av is not None and int(rows[av, 3]) > 0:
                hits += 1
                self._read_value(int(rows[av, 2]), int(rows[av, 3]))
        elif op == "put":
            puts += 1
            vwords = _value_words(key, i + 1, nwords)
            base, e, off, waste = self._alloc_span(head, nwords)
            wasted += waste
            head = base + nwords
            self._rvlog[e][off:off + nwords] = vwords
            touched.append((f"kv.vlog{e}", off, off + nwords))
            s, rows, _found = self._slot_lookup(key)
            av = self._active_row(rows)
            wv = 1 - av if av is not None else 0
            row = np.zeros(8, np.int64)
            row[0] = key + 1
            row[1] = i + 1
            row[2] = e * self.extent_words + off
            row[3] = nwords
            row[4] = _mix_words(vwords)
            row[7] = _mix_words(row[:7])
            r = 2 * s + wv
            self._rindex[r] = row
            touched.append(("kv.index", r * 8, r * 8 + 8))
            commit_row, commit_rowck = r + 1, int(row[7])
        else:  # delete
            dels += 1
            s, rows, found = self._slot_lookup(key)
            av = self._active_row(rows)
            if found and av is not None and int(rows[av, 3]) > 0:
                row = np.zeros(8, np.int64)
                row[0] = key + 1
                row[1] = i + 1
                row[7] = _mix_words(row[:7])
                r = 2 * s + (1 - av)
                self._rindex[r] = row
                touched.append(("kv.index", r * 8, r * 8 + 8))
                commit_row, commit_rowck = r + 1, int(row[7])
        mrow = np.zeros(_META_W, np.int64)
        mrow[:9] = (head, i + 1, puts, dels, gets, hits, wasted,
                    commit_row, commit_rowck)
        mrow[-1] = _mix_words(mrow[:-1])
        mv = 1 - cur_idx
        self._rmeta[mv] = mrow
        touched.append(("kv.meta", mv * _META_W, (mv + 1) * _META_W))
        # transient flush plan for adcc_after_step — always repopulated
        # by the step that immediately precedes the hook
        self._touched = touched

    def live_regions(self):
        return [self._rindex, self._rmeta] + list(self._rvlog)

    # -- oracle ------------------------------------------------------------------
    def _oracle(self):
        """Host-side replay of the request stream: per-prefix live maps
        {key: (seq, nwords)} plus final op counters."""
        if self._oracle_cache is None:
            cur: Dict[int, Tuple[int, int]] = {}
            maps = [dict(cur)]
            puts = dels = gets = hits = 0
            for i in range(self._n_steps):
                op, key, nw = self._request(i)
                if op == "put":
                    puts += 1
                    cur[key] = (i + 1, nw)
                elif op == "delete":
                    dels += 1
                    cur.pop(key, None)
                else:
                    gets += 1
                    if key in cur:
                        hits += 1
            # snapshot AFTER applying request i => maps[k] = state
            # once k requests completed
                maps.append(dict(cur))
            self._oracle_cache = (maps, {"puts": puts, "dels": dels,
                                         "gets": gets, "hits": hits})
        return self._oracle_cache

    # -- recovered-state inspection (uncharged oracle-side reads) ---------------
    def _row_ok(self, row: np.ndarray) -> bool:
        """Row checksum valid AND the referenced value bytes are exactly
        what (key, seq) wrote — direct recomputation, stronger than the
        stored value checksum."""
        if int(row[7]) != _mix_words(row[:7]):
            return False
        nw = int(row[3])
        if nw <= 0:
            return True
        key, seq, goff = int(row[0]) - 1, int(row[1]), int(row[2])
        e, off = divmod(goff, self.extent_words)
        if not (0 <= e < self.n_extents and 0 <= off
                and off + nw <= self.extent_words):
            return False
        got = self._rvlog[e].view[off:off + nw]
        return bool(np.array_equal(got, _value_words(key, seq, nw)))

    def _semantic_map(self, bound: Optional[int] = None,
                      validated: bool = False) -> Dict[int, Dict[str, int]]:
        """Live entries a reader would serve: per slot the max-seq row
        (optionally only checksum-valid rows with seq <= bound — the
        committed-prefix view restart_digest certifies), keyed by key
        with an ``ok`` integrity verdict."""
        idx = self._rindex.view
        out: Dict[int, Dict[str, int]] = {}
        for s in range(self.n_slots):
            best = None
            for v in (0, 1):
                row = idx[2 * s + v]
                if int(row[0]) == 0:
                    continue
                if bound is not None and int(row[1]) > bound:
                    continue
                if validated and not self._row_ok(row):
                    continue
                if best is None or int(row[1]) > int(best[1]):
                    best = row
            if best is not None and int(best[3]) > 0:
                out[int(best[0]) - 1] = {
                    "seq": int(best[1]), "goff": int(best[2]),
                    "nw": int(best[3]), "ok": self._row_ok(best)}
        return out

    def _visible_corrupt_rows(self) -> int:
        """Reader-visible rows (live or tombstone) failing integrity."""
        idx = self._rindex.view
        n = 0
        for s in range(self.n_slots):
            rows = idx[2 * s:2 * s + 2]
            av = self._active_row(rows)
            if av is not None and not self._row_ok(rows[av]):
                n += 1
        return n

    def _meta_row_for(self, committed: int) -> Optional[np.ndarray]:
        m = self._rmeta.view
        for v in (0, 1):
            if (int(m[v, 1]) == committed
                    and int(m[v, -1]) == _mix_words(m[v, :-1])):
                return m[v]
        return None

    # -- durability / atomicity audit --------------------------------------------
    def audit_recovery(self, rec, crash_step, torn):
        """Check the recovered store against the acknowledged prefix.

        A request is acknowledged when its step completed: a boundary
        crash acked the crashed step, a torn crash caught it in flight.
        Violations land in ``rec.info`` for ``classify_recovery``."""
        acked_n = crash_step + (0 if torn else 1)
        maps, _counters = self._oracle()
        acked = maps[acked_n]
        visible = self._semantic_map()
        atom = self._visible_corrupt_rows()
        if self._meta_row_for(rec.resume_step) is None:
            # the root the recovered run resumes from is itself torn
            atom += 1
        # a root ahead of the acknowledged prefix asserts in-flight
        # requests were applied; replay resumes past them, so any whose
        # write-set did not fully survive is a torn, partially-applied
        # request made permanently reader-visible
        for j in range(acked_n, rec.resume_step):
            op, key, _nw = self._request(j)
            if op == "get":
                continue
            ent = visible.get(key)
            if op == "put":
                if ent is None or ent["seq"] != j + 1 or not ent["ok"]:
                    atom += 1
            elif ent is not None and ent["seq"] < j + 1:
                atom += 1          # delete committed by the root, not applied
        dur = 0
        for key, (seq_o, _nw) in acked.items():
            ent = visible.get(key)
            if (ent is None or ent["seq"] < seq_o
                    or (ent["seq"] == seq_o and not ent["ok"])):
                dur += 1
        for key, ent in visible.items():
            if key not in acked and ent["ok"] and ent["seq"] <= acked_n:
                # an acknowledged delete resurrected (or a stale value
                # an acked update chain had already superseded)
                dur += 1
        rec.info["acked_requests"] = acked_n
        rec.info["durability_violations"] = dur
        rec.info["atomicity_violations"] = atom

    # -- certification digest -----------------------------------------------------
    def restart_digest(self, restart_point):
        """Semantic store digest at a restart point: the committed-prefix
        live map (key -> seq + value bytes) plus the root row — not raw
        region bytes, because a correct recovery may legitimately differ
        bytewise from the golden prefix (validate-dropped version rows,
        alternate A/B parity) while serving identical state."""
        bound = restart_point + 1
        sem = self._semantic_map(bound=bound, validated=True)
        d: Dict[str, object] = {}
        for key in sorted(sem):
            ent = sem[key]
            e, off = divmod(ent["goff"], self.extent_words)
            val = self._rvlog[e].view[off:off + ent["nw"]]
            d[f"kv:{key}"] = np.concatenate(
                ([np.int64(ent["seq"])], val)).copy()
        mrow = self._meta_row_for(bound)
        d["meta"] = (mrow.copy() if mrow is not None
                     else np.zeros(_META_W, np.int64))
        return d

    # -- ADCC hooks: per-request selective persistence ----------------------------
    def adcc_after_step(self, i):
        emu = self.emu
        for name, lo, hi in self._touched:
            emu.flush(name, lo, hi)

    def adcc_recover(self, crash_step):
        """Mount the surviving NVM image (truth == image post-crash).

        validate: pick the newest coherent root — a committed count is
        trusted only if every slot row of that generation verifies —
        then scan the index and drop torn or newer-than-root rows
        (readers fall back to the intact previous version row).
        blind: adopt the rawest root and serve whatever survived."""
        emu = self.emu
        cfg, stats = emu.cfg, emu.stats
        mview = self._rmeta.view
        meta_bytes = mview.nbytes
        raw = max(int(mview[v, 1]) for v in (0, 1))
        if self.policy == "blind":
            stats.charge_read(meta_bytes, cfg)
            resume = raw
            return RecoveryResult(
                resume_step=resume, restart_point=resume - 1,
                detect_seconds=meta_bytes / cfg.read_bw,
                redo_steps=crash_step + 1 - resume,
                from_scratch=resume == 0,
                info={"policy": "blind", "torn_flagged": False})
        valid = [v for v in (0, 1)
                 if int(mview[v, -1]) == _mix_words(mview[v, :-1])]
        idx = self._rindex.view
        read_bytes = meta_bytes + idx.nbytes
        rows_ok: Dict[int, bool] = {}
        for r in range(2 * self.n_slots):
            row = idx[r]
            if int(row[0]) == 0:
                continue
            rows_ok[r] = self._row_ok(row)
            read_bytes += 8 * max(0, int(row[3]))
        stats.charge_read(read_bytes, cfg)
        detect = read_bytes / cfg.read_bw
        resume = None
        for c, v in sorted(((int(mview[v, 1]), v) for v in valid),
                           reverse=True):
            # every surviving row of this generation must verify ...
            ok_c = all(ok or int(idx[r, 1]) != c
                       for r, ok in rows_ok.items())
            fp = int(mview[v, 7])
            if ok_c and fp:
                # ... AND the commit record's fingerprinted row must be
                # present: a root whose write-set line died with the
                # crash would otherwise be adopted vacuously, silently
                # skipping the lost request on replay
                r = fp - 1
                ok_c = (0 <= r < 2 * self.n_slots
                        and rows_ok.get(r, False)
                        and int(idx[r, 1]) == c
                        and int(idx[r, 7]) == int(mview[v, 8]))
            if ok_c:
                resume = c
                break
        if resume is None:
            self.reset()
            return RecoveryResult(
                resume_step=0, restart_point=-1, detect_seconds=detect,
                redo_steps=crash_step + 1, steps_lost=crash_step + 1,
                from_scratch=True,
                info={"policy": "validate", "torn_flagged": True,
                      "slots_dropped": 0})
        dropped = 0
        for r, ok in rows_ok.items():
            if not ok or int(idx[r, 1]) > resume:
                self._rindex[r] = 0
                self._rindex.flush(r)
                dropped += 1
        return RecoveryResult(
            resume_step=resume, restart_point=resume - 1,
            detect_seconds=detect, redo_steps=crash_step + 1 - resume,
            from_scratch=resume == 0,
            info={"policy": "validate",
                  "torn_flagged": dropped > 0 or resume < raw,
                  "slots_dropped": dropped})

    # -- cost model ----------------------------------------------------------------
    def step_cost_profile(self):
        avg_bytes = int(8 * self._prof.avg_value_words()
                        * self._prof.put_frac) + 8
        return costmodel.kv_step_profile(
            index_bytes=self._rindex.view.nbytes,
            meta_bytes=self._rmeta.view.nbytes,
            extent_bytes=self.extent_words * 8,
            n_extents=self.n_extents,
            avg_value_bytes=avg_bytes,
            line_bytes=self.emu.cfg.line_bytes)

    # -- end-of-run verdict ---------------------------------------------------------
    def finalize(self):
        maps, counters = self._oracle()
        expected = maps[self._n_steps]
        visible = self._semantic_map()
        ok = set(visible) == set(expected)
        if ok:
            for key, ent in visible.items():
                seq_o, _nw = expected[key]
                if not ent["ok"] or ent["seq"] != seq_o:
                    ok = False
                    break
        mrow = self._meta_row_for(self._n_steps)
        if mrow is None:
            ok = False
            hits = gets = wasted = 0
        else:
            hits, gets, wasted = int(mrow[5]), int(mrow[4]), int(mrow[6])
            got = {"puts": int(mrow[2]), "dels": int(mrow[3]),
                   "gets": int(mrow[4]), "hits": int(mrow[5])}
            if got != counters:
                ok = False
        return FinalReport(
            metrics={"requests": float(self._n_steps),
                     "live_keys": float(len(visible)),
                     "hit_rate": hits / max(1, gets),
                     "wasted_words": float(wasted)},
            correct=ok,
            info={"live_keys": len(visible)})


register_workload("kv", KVWorkload)
