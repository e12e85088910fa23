"""Out-of-core GROUP BY: aggregate more rows than one program can sort.

group_aggregate (ops/aggregate.py) is one resident program — its sort
working set caps the rows one device can aggregate at once. This module
scales the aggregation to bigsort's regime (1B rows) with the classic
two-phase shape:

  phase A   per run of `run_size` rows: generate on device (regenerable
            index hash; no host streaming, see sort/bigsort.py) and PARTIALLY aggregate the run in the
            same program. Only the run's padded group table (key, count,
            exact u64 sum pair) leaves the program: with G groups and R
            runs the data shrinks run_size/G-fold before anything is
            retained — aggregation IS compression, so the out-of-core
            problem collapses to an in-core combine.
  phase B   one resident combine program: sort the R partial tables by
            group key, merge equal keys (counts: u32 cumsum differences,
            exact while total < 2^32; sums: u64 pair cumsum with wrap
            carries), compact group ends, and VERIFY on device — total
            count, total u64 value sum against the closed form
            n(n-1)/2, group-key sortedness/uniqueness.

Padding discipline: phase-A tables are padded to partial_cap =
min(n_groups, run_size) with all-ones sentinel keys and zero counts/sums;
sentinels collapse into one zero-count tail group in the combine and are
dropped by the count>0 rule (a real group key is < n_groups << 2^32, so
collision with the sentinel is impossible). Both phases are
plan-free (no sampling, no capacities): the partial-table bound is
structural (num_groups <= distinct keys in run <= partial_cap).

The combine's M = R * partial_cap rows must fit one program; for G so
large that M exceeds the in-core cap, the partials would be key-range
bucketed exactly like sort/bigsort.py — asserted, not silently wrong.

Reference contrast: the reference has no aggregation at all; this is
SURVEY.md §7 step 6's GROUP BY mandate at data sizes beyond single-pass
reach, composed from the same verified machinery as the 1B-row sort.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.bits import U64
from tpu_qe.ops.aggregate import (_diff_u64, _shift_right_one,
                                  group_aggregate, segmented_reduce)
from tpu_qe.ops.segscan import cumsum_u32, cumsum_u64_pair
from tpu_qe.hashing import murmur_fmix32 as _murmur_fmix32

_ONES = jnp.uint32(0xFFFFFFFF)
_GSALT = jnp.uint32(0x9E3779B9)


def _group_of_index(idx: jnp.ndarray, n_groups: int, seed: int):
    """Group id in [0, n_groups) for row idx (device + numpy-mirrorable)."""
    return _murmur_fmix32(idx ^ (_GSALT + jnp.uint32(seed))) \
        % jnp.uint32(n_groups)


def group_of_index_numpy(idx: np.ndarray, n_groups: int,
                         seed: int = 7) -> np.ndarray:
    """Numpy mirror of _group_of_index (for oracle tests)."""
    from tpu_qe.hashing import murmur_fmix32_numpy
    h = idx.astype(np.uint32) ^ np.uint32((0x9E3779B9 + seed) & 0xFFFFFFFF)
    return (murmur_fmix32_numpy(h).astype(np.uint64)
            % np.uint64(n_groups)).astype(np.uint32)


def _aggregate_rows(idx: jnp.ndarray, n_groups: int, seed: int,
                    partial_cap: int, minmax: bool):
    """Aggregate rows with global indices `idx` and emit the padded
    partial group table (klo sentinel-padded; counts/sums zero-padded;
    min/max padded with their identities so cross-table merging stays a
    plain segmented min/max). The padding discipline here is load-bearing
    for _merge_partials — the single-chip and distributed phase-A
    programs both call this one function."""
    g = _group_of_index(idx, n_groups, seed)
    aggs = ("count", "sum") + (("min", "max") if minmax else ())
    res = group_aggregate(U64(g, jnp.zeros_like(g)), idx, aggs=aggs)
    valid = jnp.arange(partial_cap, dtype=jnp.uint32) < res.num_groups
    s = res.aggs["sum"]

    def cut(a, fill):
        return jnp.where(valid, jax.lax.slice(a, (0,), (partial_cap,)),
                         fill)

    out = (cut(res.key.lo, _ONES), cut(res.key.hi, _ONES),
           cut(res.aggs["count"], jnp.uint32(0)),
           cut(s.lo, jnp.uint32(0)), cut(s.hi, jnp.uint32(0)))
    if minmax:
        out += (cut(res.aggs["min"], _ONES),
                cut(res.aggs["max"], jnp.uint32(0)))
    return out


def _host_table(cols, minmax: bool):
    """Assemble the collect=True host group table from emitted planes."""
    cols = [np.asarray(x) for x in cols]
    gk, gc, gl, gh = cols[:4]
    keep = gc > 0
    table = {
        "key": gk[keep],
        "count": gc[keep],
        "sum": (gh[keep].astype(np.uint64) << np.uint64(32))
        | gl[keep].astype(np.uint64),
    }
    if minmax:
        table["min"] = cols[4][keep]
        table["max"] = cols[5][keep]
    return table


@functools.partial(jax.jit, static_argnames=("run_size", "n_groups",
                                             "seed", "partial_cap",
                                             "minmax"))
def _partial_run(r: jnp.ndarray, run_size: int, n_groups: int, seed: int,
                 partial_cap: int, minmax: bool):
    """One phase-A program: generate run r, aggregate it."""
    idx = r * jnp.uint32(run_size) + jnp.arange(run_size, dtype=jnp.uint32)
    return _aggregate_rows(idx, n_groups, seed, partial_cap, minmax)


def _merge_partials(cols, n_sums: int = 1):
    """Merge rows of sentinel-padded partial group tables (key-major sort
    + segmented folds), compacting merged groups to the front.

    cols: (klo, khi, cnt, slo_0, shi_0, ..., slo_{n_sums-1},
    shi_{n_sums-1}[, vmin, vmax]) row-aligned arrays — counts fold by sum
    (plain u32 cumsum differences: the global count total is < 2^32 by
    the n < 2^32 contract), each value-sum column by the exact u64 pair
    cumsum with wrap carries, min/max by segmented reductions (sentinel
    pads carry their identities, so they fold harmlessly). Pure jnp/lax —
    runs identically in the single-chip combine and inside shard_map
    bodies (ops/dbigagg.py).

    Returns (gklo, gkhi, gcnt, gsums: tuple[U64], gmin, gmax, gvalid)
    with invalid rows NOT yet masked (mask with gvalid); gmin/gmax are
    None when cols carries no min/max planes.
    """
    klo, khi = cols[0], cols[1]
    m = klo.shape[0]
    base = 3 + 2 * n_sums
    minmax = len(cols) == base + 2
    assert len(cols) in (base, base + 2), (len(cols), n_sums)
    sorted_ops = jax.lax.sort([khi, klo] + list(cols[2:]), num_keys=2,
                              is_stable=False)
    skhi, sklo, scnt = sorted_ops[:3]
    idx = jnp.arange(m, dtype=jnp.uint32)
    is_new = ((idx == 0) | (sklo != _shift_right_one(sklo, jnp.uint32(0)))
              | (skhi != _shift_right_one(skhi, jnp.uint32(0))))
    is_end = jnp.concatenate([is_new[1:], jnp.ones((1,), bool)])
    # per-group totals by prefix differences at group ends: counts via a
    # plain u32 cumsum (global total == n < 2^32, so no wrap anywhere);
    # each value-sum column via the exact u64 pair cumsum with carries
    ccnt = cumsum_u32(scnt)
    pairs = []
    for j in range(n_sums):
        plo, wraps = cumsum_u64_pair(sorted_ops[3 + 2 * j])
        phi = cumsum_u32(sorted_ops[4 + 2 * j]) + wraps
        pairs += [plo, phi]
    # compact group-end rows to the front (packed-position sort, same
    # discipline as group_aggregate)
    pos1 = idx + 1
    packed = jnp.where(is_end, pos1, pos1 | jnp.uint32(1 << 31))
    cops = [packed, sklo, skhi, ccnt] + pairs
    if minmax:
        # cross-table group min/max: segmented running min/max over the
        # key-sorted rows, read at group-end rows
        cops += [segmented_reduce(sorted_ops[base], is_new, "min"),
                 segmented_reduce(sorted_ops[base + 1], is_new, "max")]
    res = jax.lax.sort(cops, num_keys=1, is_stable=False)
    gklo, gkhi = res[1], res[2]
    gcnt = res[3] - _shift_right_one(res[3], jnp.uint32(0))
    gsums = tuple(_diff_u64(res[4 + 2 * j], res[5 + 2 * j])
                  for j in range(n_sums))
    n_all = jnp.sum(is_end.astype(jnp.uint32))      # incl. sentinel group
    gvalid = (jnp.arange(m, dtype=jnp.uint32) < n_all) & (gcnt > 0)
    gmin = res[base + 1] if minmax else None
    gmax = res[base + 2] if minmax else None
    return gklo, gkhi, gcnt, gsums, gmin, gmax, gvalid


def _verify_and_emit(merged, collect: bool, minmax: bool):
    """Device-side verification + output assembly over a merged table
    (shared by the single-chip combine and the distributed combiner —
    the closed-form invariants are the same at every tree level).

    Scalars: num_groups, total_cnt, then (tlo, thi) PER sum column, then
    keys_sorted, minmax_ok. Collect planes: key, count, per-column
    (slo, shi)[, min, max]."""
    gklo, gkhi, gcnt, gsums, gmin, gmax, gvalid = merged
    num_groups = jnp.sum(gvalid.astype(jnp.uint32))
    total_cnt = jnp.sum(jnp.where(gvalid, gcnt, 0), dtype=jnp.uint32)
    totals = ()
    for gsum in gsums:
        tlo, tw = cumsum_u64_pair(jnp.where(gvalid, gsum.lo, 0))
        thi = cumsum_u32(jnp.where(gvalid, gsum.hi, 0))[-1] + tw[-1]
        totals += (tlo[-1], thi)
    gt = ((gkhi[1:] > gkhi[:-1])
          | ((gkhi[1:] == gkhi[:-1]) & (gklo[1:] > gklo[:-1])))
    keys_sorted = jnp.all(gt | ~gvalid[1:])          # strict: unique keys
    if minmax:
        # values are the global row indices 0..n-1, so min-of-mins == 0,
        # max-of-maxes == n-1, and every group's min <= max
        mm_ok = (jnp.all(jnp.where(gvalid, gmin <= gmax, True))
                 & (jnp.min(jnp.where(gvalid, gmin, _ONES)) == 0)
                 & (jnp.max(jnp.where(gvalid, gmax, jnp.uint32(0)))
                    == total_cnt - 1))
    else:
        mm_ok = jnp.bool_(True)
    scalars = (num_groups, total_cnt) + totals + (
        keys_sorted.astype(jnp.uint32), mm_ok.astype(jnp.uint32))
    if not collect:
        return scalars
    z = jnp.uint32(0)
    out = scalars + (jnp.where(gvalid, gklo, _ONES),
                     jnp.where(gvalid, gcnt, z))
    for gsum in gsums:
        out += (jnp.where(gvalid, gsum.lo, z),
                jnp.where(gvalid, gsum.hi, z))
    if minmax:
        out += (jnp.where(gvalid, gmin, z), jnp.where(gvalid, gmax, z))
    return out


@functools.partial(jax.jit, static_argnames=("collect", "minmax"))
def _combine(parts, collect: bool, minmax: bool):
    """Phase B: merge R partial tables, verify on device, emit scalars.

    parts: tuple of (klo, khi, cnt, slo, shi[, vmin, vmax]) per run."""
    cols = tuple(jnp.concatenate([p[i] for p in parts])
                 for i in range(len(parts[0])))
    m = cols[0].shape[0]
    assert m < (1 << 28), ("combine exceeds the in-core cap; bucket the "
                           "partials (see module docstring)", m)
    return _verify_and_emit(_merge_partials(cols), collect, minmax)


@functools.partial(jax.jit, static_argnames=("run_size", "n_groups",
                                             "seed", "partial_cap",
                                             "value_cols"))
def _partial_run_multi(r: jnp.ndarray, run_size: int, n_groups: int,
                       seed: int, partial_cap: int, value_cols: int):
    """Phase-A program for the multi-column shape: one key sort shared
    by all value columns (group_aggregate_multi); emits (klo, khi, cnt,
    slo_0, shi_0, ..., slo_{V-1}, shi_{V-1}) with the same sentinel/zero
    padding discipline as _aggregate_rows."""
    from tpu_qe.ops.aggregate import group_aggregate_multi

    idx = r * jnp.uint32(run_size) + jnp.arange(run_size, dtype=jnp.uint32)
    g = _group_of_index(idx, n_groups, seed)
    values = {f"v{c}": idx + jnp.uint32(c) for c in range(value_cols)}
    aggs = {f"v{c}": (("count", "sum") if c == 0 else ("sum",))
            for c in range(value_cols)}
    res = group_aggregate_multi(U64(g, jnp.zeros_like(g)), values, aggs)
    valid = jnp.arange(partial_cap, dtype=jnp.uint32) < res.num_groups

    def cut(a, fill):
        return jnp.where(valid, jax.lax.slice(a, (0,), (partial_cap,)),
                         fill)

    out = (cut(res.key.lo, _ONES), cut(res.key.hi, _ONES),
           cut(res.aggs["v0_count"], jnp.uint32(0)))
    for c in range(value_cols):
        s = res.aggs[f"v{c}_sum"]
        out += (cut(s.lo, jnp.uint32(0)), cut(s.hi, jnp.uint32(0)))
    return out


@functools.partial(jax.jit, static_argnames=("collect", "value_cols"))
def _combine_multi(parts, collect: bool, value_cols: int):
    """Phase B for the multi-column shape: same merge, V sum pairs."""
    cols = tuple(jnp.concatenate([p[i] for p in parts])
                 for i in range(len(parts[0])))
    m = cols[0].shape[0]
    assert m < (1 << 28), ("combine exceeds the in-core cap", m)
    return _verify_and_emit(_merge_partials(cols, n_sums=value_cols),
                            collect, minmax=False)


def aggregate_big_multi(n: int, n_groups: int = 1 << 20,
                        run_size: int = 1 << 26, value_cols: int = 4,
                        seed: int = 7, verbose: bool = False,
                        collect: bool = False):
    """Multi-column out-of-core GROUP BY (the SQL shape:
    SELECT count(*), sum(v0), ..., sum(v{V-1}) GROUP BY key) — all V
    columns share each run's single key sort (group_aggregate_multi) and
    the combine's single merge; partial tables just widen by 8 B/column.

    Row i: column c's value is i + c, so every column total is closed-
    form exact on device: sum_c == n(n-1)/2 + n*c, checked per column.
    collect=True returns dict(key, count, sum0..sum{V-1}) (oracle tests).
    The distributed combine tree (ops/dbigagg.py) generalizes column-
    for-column the same way — the merge core is already V-ary.
    """
    assert n % run_size == 0, (n, run_size)
    assert n + value_cols < (1 << 32), "values travel as u32 index + c"
    assert value_cols >= 1
    n_runs = n // run_size
    partial_cap = min(n_groups, run_size)

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    run_exec = _partial_run_multi.lower(
        jnp.uint32(0), run_size=run_size, n_groups=n_groups, seed=seed,
        partial_cap=partial_cap, value_cols=value_cols).compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    parts = [run_exec(jnp.uint32(r)) for r in range(n_runs)]
    np.asarray(parts[-1][0][-1:])  # fence after queueing ALL dispatches
    t_a = time.perf_counter() - t0

    tcb = time.perf_counter()
    comb_exec = _combine_multi.lower(tuple(parts), collect=collect,
                                     value_cols=value_cols).compile()
    compile_s += time.perf_counter() - tcb

    n_scal = 4 + 2 * value_cols
    t1 = time.perf_counter()
    out = comb_exec(tuple(parts))
    scal = [int(np.asarray(x)) for x in out[:n_scal]]
    t_b = time.perf_counter() - t1
    ng, total_cnt = scal[0], scal[1]
    ks = scal[-2]
    sums_ok = all(
        ((scal[3 + 2 * c] << 32) | scal[2 + 2 * c])
        == n * (n - 1) // 2 + n * c
        for c in range(value_cols))
    dt = t_a + t_b
    res = BigAggResult(
        n=n, n_groups=ng, seconds=dt, rows_per_s=n / dt,
        count_ok=(total_cnt == n), sum_ok=sums_ok, keys_ok=bool(ks),
        groups_ok=(ng <= min(n_groups, n)),
        phase_a_s=t_a, phase_b_s=t_b, compile_s=compile_s)
    if verbose:
        print(f"bigagg-multi: n={n} V={value_cols} R={n_runs} "
              f"G={n_groups} groups={ng} A={t_a:.2f}s B={t_b:.2f}s "
              f"ok={res.all_ok}")
    if collect:
        cols = [np.asarray(x) for x in out[n_scal:]]
        gk, gc = cols[0], cols[1]
        keep = gc > 0
        table = {"key": gk[keep], "count": gc[keep]}
        for c in range(value_cols):
            lo, hi = cols[2 + 2 * c], cols[3 + 2 * c]
            table[f"sum{c}"] = (hi[keep].astype(np.uint64)
                                << np.uint64(32)) | lo[keep].astype(
                np.uint64)
        return res, table
    return res


@dataclasses.dataclass(frozen=True)
class BigAggResult:
    n: int
    n_groups: int              # groups found (count > 0)
    seconds: float
    rows_per_s: float
    count_ok: bool             # sum of group counts == n
    sum_ok: bool               # total u64 value sum == n(n-1)/2
    keys_ok: bool              # group keys strictly ascending (unique)
    groups_ok: bool            # group count within the structural bound
    #   (exact per-group counts/sums are oracle-checked in tests via
    #   collect=True + numpy bincount; the closed-form count/sum totals
    #   above are the at-scale on-device checks)
    phase_a_s: float
    phase_b_s: float
    compile_s: float = 0.0
    minmax_ok: bool = True     # min<=max per group, global min 0 / max n-1
    #   (vacuously true unless minmax aggregation was requested)

    @property
    def all_ok(self) -> bool:
        return (self.count_ok and self.sum_ok and self.keys_ok
                and self.groups_ok and self.minmax_ok)


def _run_ck_path(directory: str, r: int) -> str:
    return os.path.join(directory, f"bigagg_run{r}.npz")


def _run_ck_load(directory: str, r: int, meta: np.ndarray):
    """Load run r's persisted partial table if it matches this config."""
    p = _run_ck_path(directory, r)
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        if not np.array_equal(z["meta"], meta):
            return None
        return tuple(jnp.asarray(z[f"c{i}"])
                     for i in range(int(z["ncols"])))


def _run_ck_save(directory: str, r: int, meta: np.ndarray, part) -> None:
    cols = {f"c{i}": np.asarray(a) for i, a in enumerate(part)}
    tmp = _run_ck_path(directory, r) + ".tmp.npz"
    np.savez(tmp, meta=meta, ncols=len(part), **cols)
    os.replace(tmp, _run_ck_path(directory, r))


def aggregate_big(n: int, n_groups: int = 1 << 20, run_size: int = 1 << 26,
                  seed: int = 7, verbose: bool = False,
                  collect: bool = False, minmax: bool = False,
                  checkpoint_dir: str | None = None):
    """Out-of-core GROUP BY count+sum (optionally min+max) of n
    device-generated rows.

    Row i: group key = hash(i) mod n_groups, value = i — so the global
    invariants are closed-form exact: counts sum to n and the u64 value
    total equals n(n-1)/2, both checked on device (minmax adds per-group
    min<=max plus global-min==0 / global-max==n-1). Peak HBM ~ one run's
    aggregation working set + R * partial_cap * 20-28 B of partial tables.

    collect=True additionally returns the assembled host group table
    dict(key, count, sum[, min, max]) in key order (small-n oracle tests
    only).

    checkpoint_dir: unlike the bucketed drivers (whose plans are the
    scarce state), here the PARTIAL TABLES are the checkpoint — they are
    the entire surviving product of phase A and G-bounded-small. Each
    run's table persists atomically after its readback; a restarted run
    loads matching tables and computes only the missing runs. Opt-in
    cost: persisting forces a per-run host readback (~partial_cap*20-28 B)
    instead of fire-and-forget queueing.
    """
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 32), "values travel as u32 global index"
    n_runs = n // run_size
    partial_cap = min(n_groups, run_size)
    meta = np.asarray([n, n_groups, run_size, seed, int(minmax)], np.int64)

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    run_exec = _partial_run.lower(
        jnp.uint32(0), run_size=run_size, n_groups=n_groups, seed=seed,
        partial_cap=partial_cap, minmax=minmax).compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    if checkpoint_dir is None:
        parts = [run_exec(jnp.uint32(r)) for r in range(n_runs)]
        np.asarray(parts[-1][0][-1:])  # fence after queueing ALL dispatches
    else:
        parts, resumed = [], 0
        for r in range(n_runs):
            part = _run_ck_load(checkpoint_dir, r, meta)
            if part is not None:
                resumed += 1
            else:
                part = run_exec(jnp.uint32(r))
                _run_ck_save(checkpoint_dir, r, meta, part)
            parts.append(part)
        if verbose and resumed:
            print(f"bigagg: resuming — {resumed}/{n_runs} run tables "
                  "loaded from checkpoint")
    t_a = time.perf_counter() - t0

    tcb = time.perf_counter()
    comb_exec = _combine.lower(tuple(parts), collect=collect,
                               minmax=minmax).compile()
    compile_s += time.perf_counter() - tcb

    t1 = time.perf_counter()
    out = comb_exec(tuple(parts))
    scal = [np.asarray(x) for x in out[:6]]
    t_b = time.perf_counter() - t1
    ng, total_cnt, tlo, thi, ks, mm = (int(x) for x in scal)
    want = n * (n - 1) // 2
    got_sum = (thi << 32) | tlo
    dt = t_a + t_b
    res = BigAggResult(
        n=n, n_groups=ng, seconds=dt, rows_per_s=n / dt,
        count_ok=(total_cnt == n), sum_ok=(got_sum == want),
        keys_ok=bool(ks), groups_ok=(ng <= min(n_groups, n)),
        phase_a_s=t_a, phase_b_s=t_b, compile_s=compile_s,
        minmax_ok=bool(mm))
    if verbose:
        print(f"bigagg: n={n} R={n_runs} G={n_groups} "
              f"partial_cap={partial_cap} groups={ng} "
              f"A={t_a:.2f}s B={t_b:.2f}s ok={res.all_ok}")
    if collect:
        return res, _host_table(out[6:], minmax)
    return res
