"""Out-of-core COUNT(DISTINCT value) GROUP BY key — dedup as compression.

The out-of-core aggregate (ops/bigagg.py) survives on "aggregation IS
compression": only partial group tables leave each run. COUNT DISTINCT
has the same property one level up: only each run's DISTINCT
(key, value) PAIRS carry information — phase A dedups every run on
device (sort + pair-boundary compaction, the same kernel shape as
ops/aggregate.py's count_distinct), and phase B merges the R partial
pair tables in one resident program (cross-run duplicates collapse in
its (key, value) sort) and counts pair runs per key:

  phase A   per run: generate rows on device (regenerable index
            functions; no host streaming),
            sort (key, value), compact distinct pairs + their exact
            occurrence counts to a padded prefix. Overflow of the
            partial capacity is DETECTED exactly (count readback),
            never truncated silently.
  phase B   one program over the R tables: (key, value) sort, boundary
            dedup (a pair seen by many runs counts once), per-key
            distinct counts AND per-key row counts (the pair occurrence
            counts survive dedup by summation), compaction, full
            on-device verification.

Data model (closed-form verifiable at any scale): key = idx mod G,
value = (idx div G) mod V — every group holds exactly n/G rows and
exactly min(n/G, V) distinct values, so phase B proves on device:
num_groups == G, every distinct count == min(n/G, V), every row count
== n/G, keys sorted unique. Keys are scattered round-robin so the
phase-A sorts do full-entropy work.

Reference contrast: the reference has no aggregation; this extends the
SURVEY §7 operator mandate's GROUP BY family (see ops/bigagg.py) with
the dedup-shaped aggregate at out-of-core scale.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.ops.aggregate import _shift_right_one
from tpu_qe.ops.segscan import cumsum_u32

_ONES = jnp.uint32(0xFFFFFFFF)


def rows_of_index(idx: jnp.ndarray, n_groups: int, n_values: int):
    """(key, value) for global row idx — device + numpy-mirrorable."""
    g = idx % jnp.uint32(n_groups)
    v = (idx // jnp.uint32(n_groups)) % jnp.uint32(n_values)
    return g, v


def rows_of_index_numpy(idx: np.ndarray, n_groups: int, n_values: int):
    idx = idx.astype(np.uint64)
    return ((idx % np.uint64(n_groups)).astype(np.uint32),
            ((idx // np.uint64(n_groups)) % np.uint64(n_values))
            .astype(np.uint32))


@functools.partial(jax.jit, static_argnames=("run_size", "n_groups",
                                             "n_values", "partial_cap"))
def _dedup_run(r: jnp.ndarray, run_size: int, n_groups: int,
               n_values: int, partial_cap: int):
    """Phase A: run r's distinct (key, value, occurrences) padded table
    + the exact distinct-pair count (overflow detection)."""
    idx = r * jnp.uint32(run_size) + jnp.arange(run_size, dtype=jnp.uint32)
    g, v = rows_of_index(idx, n_groups, n_values)
    sg, sv = jax.lax.sort([g, v], num_keys=2, is_stable=False)
    pos = jnp.arange(run_size, dtype=jnp.uint32)
    pair_new = ((pos == 0) | (sg != _shift_right_one(sg, 0))
                | (sv != _shift_right_one(sv, 0)))
    m = jnp.sum(pair_new.astype(jnp.uint32))
    # occurrences of each pair: position differences at pair-end rows
    pair_end = jnp.concatenate([pair_new[1:], jnp.ones((1,), bool)])
    # compact pair-END rows (carrying the inclusive position) to read
    # occurrence counts, aligned with the compacted pair-start keys
    pos1 = pos + 1
    packed = jnp.where(pair_end, pos1, pos1 | jnp.uint32(1 << 31))
    res = jax.lax.sort([packed, sg, sv], num_keys=1, is_stable=False)
    pe = res[0] & jnp.uint32(0x7FFFFFFF)
    occ = pe - _shift_right_one(pe, 0)
    valid = jnp.arange(partial_cap, dtype=jnp.uint32) < m

    def cut(a, fill):
        return jnp.where(valid, jax.lax.slice(a, (0,), (partial_cap,)),
                         fill)

    return (cut(res[1], _ONES), cut(res[2], jnp.uint32(0)),
            cut(occ, jnp.uint32(0)), m)


@functools.partial(jax.jit, static_argnames=("n", "n_groups", "n_values",
                                             "collect"))
def _combine(klo, v, occ, n: int, n_groups: int, n_values: int,
             collect: bool):
    """Phase B: merge the concatenated partial pair tables and verify.

    Sentinel rows (klo all-ones, occ 0) sort to the tail and form a
    zero-count pseudo group dropped by the occ-total rule."""
    m = klo.shape[0]
    skey, sv, socc = jax.lax.sort([klo, v, occ], num_keys=2,
                                  is_stable=False)
    pos = jnp.arange(m, dtype=jnp.uint32)
    sent = skey == _ONES
    key_new = ((pos == 0) | (skey != _shift_right_one(skey, 0))) & ~sent
    pair_new = (key_new | (sv != _shift_right_one(sv, 0))) & ~sent
    key_end = ~sent & jnp.concatenate(
        [(key_new | sent)[1:], jnp.ones((1,), bool)])
    num_groups = jnp.sum(key_end.astype(jnp.uint32))
    cum_nd = cumsum_u32(pair_new.astype(jnp.uint32))
    cum_occ = cumsum_u32(socc)  # total rows: n < 2^32 by contract
    # compact key-end rows: distinct counts + row counts per key
    pos1 = pos + 1
    packed = jnp.where(key_end, pos1, pos1 | jnp.uint32(1 << 31))
    res = jax.lax.sort([packed, skey, cum_nd, cum_occ], num_keys=1,
                       is_stable=False)
    gkey = res[1]
    gcd = res[2] - _shift_right_one(res[2], 0)
    gcnt = res[3] - _shift_right_one(res[3], 0)
    gvalid = jnp.arange(m, dtype=jnp.uint32) < num_groups
    # closed-form verification (data model in the module docstring):
    # group g holds n//G rows (+1 for g < n mod G), each with values
    # 0..count-1 mod V consecutive -> distinct = min(count, V)
    want_cnt = (jnp.uint32(n // n_groups)
                + (gkey < jnp.uint32(n % n_groups)).astype(jnp.uint32))
    want_cd = jnp.minimum(want_cnt, jnp.uint32(n_values))
    groups_ok = num_groups == jnp.uint32(min(n_groups, n))
    cd_ok = jnp.all(jnp.where(gvalid, gcd == want_cd, True))
    cnt_ok = jnp.all(jnp.where(gvalid, gcnt == want_cnt, True))
    keys_ok = jnp.all(
        jnp.where(gvalid[1:],
                  gkey[1:] > gkey[:-1], True)) if m > 1 else jnp.bool_(True)
    checks = (groups_ok, cd_ok, cnt_ok, keys_ok, num_groups)
    if collect:
        return checks, (jnp.where(gvalid, gkey, _ONES),
                        jnp.where(gvalid, gcd, 0),
                        jnp.where(gvalid, gcnt, 0))
    return checks, ()


@dataclasses.dataclass
class BigDistinctResult:
    n: int
    n_groups: int
    n_values: int
    n_runs: int
    num_groups: int
    groups_ok: bool
    cd_ok: bool
    cnt_ok: bool
    keys_ok: bool
    overflow: bool            # any run's distinct pairs > partial_cap
    seconds: float
    dedup_s: float
    combine_s: float
    rows_per_s: float
    table: dict | None = None

    @property
    def all_ok(self) -> bool:
        return (self.groups_ok and self.cd_ok and self.cnt_ok
                and self.keys_ok and not self.overflow
                and self.num_groups == min(self.n_groups, self.n))


def count_distinct_big(n: int, n_groups: int = 1 << 20,
                       n_values: int = 1 << 10, run_size: int = 1 << 26,
                       partial_cap: int | None = None,
                       collect: bool = False, verbose: bool = False
                       ) -> BigDistinctResult:
    """COUNT(DISTINCT value) GROUP BY key over n device-generated rows,
    out-of-core (see module docstring)."""
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 32) and n_groups < (1 << 32) - 1
    n_runs = n // run_size
    if partial_cap is None:
        # structural bound for this data model; pad to the lane tile
        partial_cap = min(run_size, n_groups * n_values)
        partial_cap = min(-(-partial_cap // 128) * 128, run_size)
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    mk = _dedup_run.lower(jnp.uint32(0), run_size=run_size,
                          n_groups=n_groups, n_values=n_values,
                          partial_cap=partial_cap).compile()
    m_tot = n_runs * partial_cap
    ex = jax.ShapeDtypeStruct((m_tot,), jnp.uint32)
    cb = _combine.lower(ex, ex, ex, n=n, n_groups=n_groups,
                        n_values=n_values, collect=collect).compile()

    t0 = time.perf_counter()
    parts, m_counts = [], []
    for rr in range(n_runs):
        klo, v, occ, m = mk(jnp.uint32(rr))
        parts.append((klo, v, occ))
        m_counts.append(m)
    m_host = np.array([int(np.asarray(m)) for m in m_counts])  # fence A
    overflow = bool((m_host > partial_cap).any())
    t1 = time.perf_counter()
    klo = jnp.concatenate([p[0] for p in parts])
    v = jnp.concatenate([p[1] for p in parts])
    occ = jnp.concatenate([p[2] for p in parts])
    checks, planes = cb(klo, v, occ)
    groups_ok, cd_ok, cnt_ok, keys_ok, num_groups = \
        (np.asarray(c) for c in checks)
    t2 = time.perf_counter()
    table = None
    if collect:
        gk, gcd, gcnt = (np.asarray(p) for p in planes)
        keep = gk != 0xFFFFFFFF
        table = {"key": gk[keep], "count_distinct": gcd[keep],
                 "count": gcnt[keep]}
    if verbose:
        print(f"bigdistinct: {n_runs} runs dedup {t1 - t0:.2f}s "
              f"(pairs/run max {m_host.max()}), combine {t2 - t1:.2f}s")
    secs = t2 - t0
    return BigDistinctResult(
        n=n, n_groups=n_groups, n_values=n_values, n_runs=n_runs,
        num_groups=int(num_groups), groups_ok=bool(groups_ok),
        cd_ok=bool(cd_ok), cnt_ok=bool(cnt_ok), keys_ok=bool(keys_ok),
        overflow=overflow, seconds=secs, dedup_s=t1 - t0,
        combine_s=t2 - t1, rows_per_s=n / secs, table=table)
