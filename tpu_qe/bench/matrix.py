"""Benchmark matrix: the BASELINE.json operator configs, measured honestly.

Each config prints one JSON line (same schema as bench.py). Data is
generated on-device (jax.random), so host->device transfer stays out of the
timed region. Each config is timed end to end, ended by
jax.block_until_ready.

Configs (BASELINE.md):
  sort64m        radix sort 64M u64 + payload, 1 chip      (same as bench.py)
  filter_agg     filter + GROUP BY aggregate over 256M rows, 1 chip
  join           FK equi-join 2 x 100M rows, 1 chip (scan-join)
  join_agg       join -> GROUP BY, fused key-sorted stream vs unfused
  window         row_number+rank+running_sum over 128M rows, 1 chip
  orderby        multi-column ORDER BY (mixed types/directions), 1 chip
  count_distinct GROUP BY COUNT(DISTINCT value), 1 chip
  quantile       per-group exact PERCENTILE_DISC p50+p99, 1 chip
  setop          INTERSECT distinct of overlapping key columns, 1 chip
  dsort          distributed sample-sort over the local mesh (all devices)
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.bench.sol import device_kind
from tpu_qe.bits import U64
from tpu_qe.utils.timing import measure


def _rand_u32(key, n):
    return jax.random.bits(key, (n,), dtype=jnp.uint32)


def _emit(name: str, n_rows: int, seconds: float, extra=None):
    row = {
        "metric": name,
        "value": round(n_rows / seconds),
        "unit": "rows/s",
        "time_s": round(seconds, 4),
        "rows": n_rows,
        "device": device_kind(),
    }
    row.update(extra or {})
    print(json.dumps(row), flush=True)
    return row


def bench_filter_agg(n: int = 1 << 28, groups: int = 1 << 20,
                     reps: int = 2):
    """Filter (~50% selectivity) + GROUP BY count/sum over n rows."""
    from tpu_qe.ops.aggregate import group_aggregate

    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(7), 3)
    # group ids spread over `groups` distinct 64-bit morton-cell-style keys
    gid = jax.random.randint(k0, (n,), 0, groups, dtype=jnp.int32)
    key = U64((gid.view(jnp.uint32) * jnp.uint32(2654435761)),
              gid.view(jnp.uint32) >> 13)
    val = _rand_u32(k1, n)

    @jax.jit
    def run(key, val):
        # filter fused into the aggregation sort (valid mask) — one sort
        # instead of compact + sort. The max_groups gather extraction is
        # meant for low-cardinality GROUP BY — see ops/aggregate.py.
        res = group_aggregate(key, val, aggs=("count", "sum"),
                              valid=val < jnp.uint32(1 << 30))
        return res.num_groups, res.aggs["sum"].lo[:8]

    secs = measure(lambda: run(key, val), reps=reps)
    return _emit(f"filter + group aggregate, {n} rows, 1 chip", n, secs,
                 {"groups": groups})


def bench_pipeline(n: int = 1 << 26, reps: int = 2):
    """Flagship at scale: morton-encode n points + sort (code, index)."""
    from tpu_qe import morton
    from tpu_qe.sort import sort_u64

    k = jax.random.split(jax.random.PRNGKey(11), 3)
    x = jax.random.uniform(k[0], (n,), jnp.float32, -100, 100)
    y = jax.random.uniform(k[1], (n,), jnp.float32, -100, 100)
    z = jax.random.uniform(k[2], (n,), jnp.float32, -100, 100)
    params = morton.MortonParams.for_scene(
        np.array([-100.0] * 3, np.float32), np.array([100.0] * 3, np.float32))

    @jax.jit
    def run(x, y, z, params):
        code = morton.encode_points(x, y, z, params)
        idx = jnp.arange(x.shape[0], dtype=jnp.uint32)
        skey, (sidx,) = sort_u64(code, idx, backend="xla_tiebreak")
        return skey.lo[:8], sidx[:8]

    secs = measure(lambda: run(x, y, z, params), reps=reps)
    return _emit(f"morton encode + sort pipeline, {n} points, 1 chip",
                 n, secs)


def bench_join(n: int = 100_000_000, reps: int = 2):
    """FK equi-join: n left rows probe n unique right keys (scan-join)."""
    from tpu_qe.ops.join import join_fk_scan
    from tpu_qe.table import Table

    k0, k1 = jax.random.split(jax.random.PRNGKey(3))
    # unique right keys: a bijective mix of arange
    r = jnp.arange(n, dtype=jnp.uint32)
    rkey = U64(r * jnp.uint32(2654435761) ^ jnp.uint32(0x9E3779B9), r)
    rval = _rand_u32(k0, n)
    # left keys: random picks of right keys (all match)
    pick = jax.random.randint(k1, (n,), 0, n, dtype=jnp.int32)
    lkey = U64(jnp.take(rkey.lo, pick), jnp.take(rkey.hi, pick))

    @jax.jit
    def run(lkey, rkey, rval):
        left = Table({"li": jnp.arange(lkey.lo.shape[0], dtype=jnp.uint32)})
        right = Table({"rval": rval})
        out, matched = join_fk_scan(left, right, lkey, rkey)
        return jnp.sum(matched.astype(jnp.uint32)), out["rval"][:8]

    secs = measure(lambda: run(lkey, rkey, rval), reps=reps)
    return _emit(f"fk scan-join, {n} x {n} rows, 1 chip", 2 * n, secs)


def bench_join_agg(n: int = 100_000_000, groups: int | None = None,
                   reps: int = 2):
    """Join -> GROUP BY sum, fused via the key-sorted stream vs unfused.

    The fused path (join_fk_scan(output="stream") +
    group_aggregate_sorted) runs TWO large sorts — the join's combined
    sort and the aggregate compaction — where the unfused path runs four
    (those two plus the join restore sort and the aggregate's own key
    sort). Emits both configs so the saving is measured, not claimed.
    """
    from tpu_qe.ops.aggregate import group_aggregate, group_aggregate_sorted
    from tpu_qe.ops.join import join_fk_scan
    from tpu_qe.table import Table

    if groups is None:
        groups = max(n // 64, 1)
    k0, k1 = jax.random.split(jax.random.PRNGKey(9))
    r = jnp.arange(n, dtype=jnp.uint32)
    rkey = U64(r * jnp.uint32(2654435761) ^ jnp.uint32(0x9E3779B9), r)
    rval = _rand_u32(k0, n)
    pick = jax.random.randint(k1, (n,), 0, groups, dtype=jnp.int32)
    lkey = U64(jnp.take(rkey.lo, pick), jnp.take(rkey.hi, pick))
    dummy = jnp.zeros(n, jnp.uint32)

    @jax.jit
    def run_fused(lkey, rkey, rval, dummy):
        st = join_fk_scan(Table({"z": dummy}), Table({"rval": rval}),
                          lkey, rkey, output="stream")
        res = group_aggregate_sorted(st.key, st.values["rval"],
                                     aggs=("count", "sum"),
                                     valid=st.matched)
        return res.num_groups, res.aggs["sum"].lo[:8]

    @jax.jit
    def run_unfused(lkey, rkey, rval, dummy):
        out, matched = join_fk_scan(Table({"z": dummy}),
                                    Table({"rval": rval}), lkey, rkey)
        res = group_aggregate(lkey, out["rval"], aggs=("count", "sum"),
                              valid=matched)
        return res.num_groups, res.aggs["sum"].lo[:8]

    s_f = measure(lambda: run_fused(lkey, rkey, rval, dummy), reps=reps)
    s_u = measure(lambda: run_unfused(lkey, rkey, rval, dummy), reps=reps)
    _emit(f"join + GROUP BY sum (unfused), {n} x {n} rows, 1 chip", n, s_u,
          {"groups": groups})
    return _emit(f"join + GROUP BY sum (fused stream), {n} x {n} rows, "
                 "1 chip", n, s_f,
                 {"groups": groups, "speedup_vs_unfused":
                  round(s_u / s_f, 3)})


def bench_window(n: int = 1 << 27, partitions: int = 1 << 16,
                 reps: int = 2):
    """Window functions (row_number + rank + exact-u64 running sum) over
    n rows: one (key, order, position) sort + segmented sweeps + the
    input-order restore sort (ops/window.py)."""
    from tpu_qe.ops.window import window

    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(13), 3)
    pid = jax.random.randint(k0, (n,), 0, partitions, dtype=jnp.int32)
    key = U64(pid.view(jnp.uint32) * jnp.uint32(2654435761),
              pid.view(jnp.uint32) >> 9)
    order = _rand_u32(k1, n)
    val = _rand_u32(k2, n)
    funcs = {"rn": ("row_number",), "rk": ("rank",),
             "cum": ("running_sum", "v")}

    def run():
        res = window(key, funcs, order=order, values={"v": val})
        return res.cols["rn"][:8], res.cols["cum"].lo[:8]

    secs = measure(run, reps=reps)
    out = _emit(f"window rn+rank+running_sum, {n} rows, 1 chip", n, secs,
                {"partitions": partitions})

    # round-5 frame kinds: a centered FOLLOWING frame (reversed-sweep
    # composition) + the tie-aware unbounded RANGE frame
    funcs2 = {"cs": ("moving_sum", "v", 4, 3),
              "ru": ("range_sum", "v", "unbounded")}

    def run2():
        res = window(key, funcs2, order=order, values={"v": val})
        return res.cols["cs"].lo[:8], res.cols["ru"].lo[:8]

    secs2 = measure(run2, reps=reps)
    _emit(f"window centered frame + RANGE unbounded, {n} rows, 1 chip",
          n, secs2, {"partitions": partitions})
    return out


def bench_orderby(n: int = 1 << 27, reps: int = 2):
    """Multi-column ORDER BY (u64 DESC, i32 ASC, f32 DESC + u32 payload)
    over n rows: ONE lexicographic unstable sort with the position as
    the stability key (ops/orderby.py)."""
    from tpu_qe.ops.orderby import sort_by_multi
    from tpu_qe.table import Table

    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(21), 4)
    t = Table({
        "a": U64(_rand_u32(k0, n) & jnp.uint32(0xFFF), jnp.zeros(n, jnp.uint32)),
        "b": _rand_u32(k1, n).view(jnp.int32),
        "f": jax.random.normal(k2, (n,), dtype=jnp.float32),
        "pay": _rand_u32(k3, n),
    })
    by = [("a", "desc"), "b", ("f", "desc")]

    def run():
        st = sort_by_multi(t, by)
        return st["pay"][:8]

    secs = measure(run, reps=reps)
    return _emit(f"ORDER BY a DESC, b, f DESC (+payload), {n} rows, 1 chip",
                 n, secs)


def bench_count_distinct(n: int = 1 << 27, groups: int = 1 << 14,
                         reps: int = 2):
    """GROUP BY key COUNT(DISTINCT value) + count over n rows
    (ops/aggregate.py count_distinct: the (key, value) aggregation sort
    + one distinct-pair cumsum + the packed compaction sort)."""
    from tpu_qe.ops.aggregate import group_aggregate

    k0, k1 = jax.random.split(jax.random.PRNGKey(22))
    g = jax.random.randint(k0, (n,), 0, groups, dtype=jnp.int32)
    key = U64(g.view(jnp.uint32) * jnp.uint32(2654435761),
              g.view(jnp.uint32) >> 7)
    val = _rand_u32(k1, n) & jnp.uint32(0x3FF)  # ~1K distinct per group

    def run():
        res = group_aggregate(key, val,
                              aggs=("count", "count_distinct"))
        return res.num_groups, res.aggs["count_distinct"][:8]

    secs = measure(run, reps=reps)
    return _emit(f"GROUP BY COUNT(DISTINCT), {n} rows, 1 chip", n, secs,
                 {"groups": groups})


def bench_quantile(n: int = 1 << 27, groups: int = 1 << 14,
                   reps: int = 2):
    """Per-group exact PERCENTILE_DISC (p50 + p99) over n rows
    (ops/quantile.py: the GROUP BY two-sort structure + rank gathers)."""
    from tpu_qe.ops.quantile import group_quantile

    k0, k1 = jax.random.split(jax.random.PRNGKey(23))
    g = jax.random.randint(k0, (n,), 0, groups, dtype=jnp.int32)
    key = U64(g.view(jnp.uint32) * jnp.uint32(2654435761),
              g.view(jnp.uint32) >> 7)
    val = _rand_u32(k1, n)

    def run():
        # max_groups extraction: the compaction sort AND the rank
        # gathers are groups-bounded (see ops/quantile._group_layout_mg)
        res = group_quantile(key, val, [(1, 1), 0.99],
                             max_groups=groups)
        return res.num_groups, res.quantiles[:, :8]

    secs = measure(run, reps=reps)
    return _emit(f"GROUP BY p50+p99 (exact), {n} rows, 1 chip", n, secs,
                 {"groups": groups})


def bench_setop(n: int = 1 << 27, reps: int = 2):
    """INTERSECT (distinct) of n vs n/2 overlapping u64 key columns:
    one (key, side) sort + two packed compactions (ops/setops.py)."""
    from tpu_qe.ops.setops import set_op

    k0, k1 = jax.random.split(jax.random.PRNGKey(29))
    a = U64(_rand_u32(k0, n) & jnp.uint32(0x3FFFFF), jnp.zeros(n, jnp.uint32))
    m = n // 2
    b = U64(_rand_u32(k1, m) & jnp.uint32(0x3FFFFF), jnp.zeros(m, jnp.uint32))

    def run():
        keys, ca, cb, num = set_op(a, b, "intersect")
        return num, keys.lo[:8]

    secs = measure(run, reps=reps)
    return _emit(f"INTERSECT {n} vs {m} u64 keys, 1 chip", n + m, secs)


def bench_dsort(n: int = 1 << 26, zipf: bool = True, reps: int = 2):
    """Distributed sample-sort over all local devices (skewed keys)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_qe.exchange import distributed_sort, make_mesh

    mesh = make_mesh()
    d = mesh.shape["x"]
    k0 = jax.random.PRNGKey(5)
    if zipf:
        # Zipf-ish skew: exponentiate a uniform to concentrate mass
        u = jax.random.uniform(k0, (n,), dtype=jnp.float32)
        skew = (u ** 4 * (1 << 30)).astype(jnp.uint32)
        lo, hi = skew * jnp.uint32(2654435761), skew >> 8
    else:
        lo = _rand_u32(k0, n)
        hi = _rand_u32(jax.random.fold_in(k0, 1), n)
    sharding = NamedSharding(mesh, P("x"))
    key = U64(jax.device_put(lo, sharding), jax.device_put(hi, sharding))
    pay = jax.device_put(jnp.arange(n, dtype=jnp.uint32), sharding)

    def run():
        res, overflow = distributed_sort(key, pay, mesh=mesh,
                                         capacity_factor=4.0)
        return res.key.lo, overflow

    secs = measure(run, reps=reps)
    return _emit(f"distributed sample-sort, {n} u64 keys"
                 f" ({'zipf' if zipf else 'uniform'}), {d} device(s)", n,
                 secs, {"devices": d})


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--configs", type=str,
                   default="pipeline,filter_agg,join,join_agg,window,dsort")
    p.add_argument("--scale", type=float, default=1.0,
                   help="row-count multiplier (e.g. 0.1 for smoke runs)")
    a = p.parse_args(argv)
    s = a.scale
    for c in a.configs.split(","):
        if c == "pipeline":
            bench_pipeline(n=max(int((1 << 26) * s), 1 << 12))
        elif c == "filter_agg":
            bench_filter_agg(n=max(int((1 << 28) * s), 1 << 12))
        elif c == "join":
            bench_join(n=max(int(100e6 * s), 1 << 12))
        elif c == "join_agg":
            bench_join_agg(n=max(int(100e6 * s), 1 << 12))
        elif c == "window":
            bench_window(n=max(int((1 << 27) * s), 1 << 12))
        elif c == "orderby":
            bench_orderby(n=max(int((1 << 27) * s), 1 << 12))
        elif c == "count_distinct":
            bench_count_distinct(n=max(int((1 << 27) * s), 1 << 12))
        elif c == "quantile":
            bench_quantile(n=max(int((1 << 27) * s), 1 << 12))
        elif c == "setop":
            bench_setop(n=max(int((1 << 27) * s), 1 << 12))
        elif c == "dsort":
            bench_dsort(n=max(int((1 << 26) * s) // 8 * 8, 1 << 12))
        else:
            raise SystemExit(f"unknown config {c!r}")


if __name__ == "__main__":
    main()
