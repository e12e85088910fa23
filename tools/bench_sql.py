"""SQL-layer macro benchmark: one representative analytics query at
scale, with the SAME plan hand-composed from the operators as the
overhead control.

Prints two JSON lines: the SQL-executed query and the direct operator
composition. The front-end cost is parse + plan + the host readbacks it
shares with the direct path (filter count, group count) — the device
programs are identical, so rows/s should match within noise.

Usage: python tools/bench_sql.py [--n 134217728] [--groups 4096]
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def _mk_table(n: int, groups: int, seed: int = 7):
    """Device-generated table (hash of index — nothing crosses from
    the host; same data model as the big-driver benches)."""
    from tpu_qe.hashing import keygen_hash, murmur_fmix32
    idx = jnp.arange(n, dtype=jnp.uint32)
    k = keygen_hash(idx, seed)
    key = k.lo & jnp.uint32(groups - 1)
    v = (murmur_fmix32(idx ^ jnp.uint32(0xA5A5A5A5))
         & jnp.uint32(0xFFFF)).view(jnp.int32)
    return key, v


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 27)
    ap.add_argument("--groups", type=int, default=4096)
    args = ap.parse_args()
    n, groups = args.n, args.groups
    assert groups & (groups - 1) == 0

    from tpu_qe.sql import Database
    from tpu_qe.ops.aggregate import group_aggregate_multi
    from tpu_qe.ops.filter import compact
    from tpu_qe.table import Table
    from tpu_qe.bits import U64

    key, v = _mk_table(n, groups)
    jax.block_until_ready(key)  # generation stays out of the timing

    db = Database()
    db.register("t", Table({"k": key, "v": v}))
    sql = ("SELECT k, COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, "
           "MAX(v) AS mx FROM t WHERE v % 4 <> 0 GROUP BY k ORDER BY k")

    # warm both paths (compiles excluded from timing)
    out = db.sql(sql)
    t0 = time.perf_counter()
    out = db.sql(sql)
    t_sql = time.perf_counter() - t0

    def direct():
        from tpu_qe.sql.executor import _head_np
        mask = (v % jnp.int32(4)) != 0
        ct, cnt = compact(Table({"k": key, "v": v}), mask)
        m = int(np.asarray(cnt))
        ct = ct.head(m)
        gkey = U64(ct["k"], jnp.zeros(m, jnp.uint32))
        res = group_aggregate_multi(gkey, {"v": ct["v"]},
                                    {"v": ("sum", "min", "max", "count")})
        # G-bounded readbacks: slice on device before the transfer (the
        # padded outputs are n-sized)
        g = int(np.asarray(res.num_groups))
        return {"k": _head_np(res.key.lo, g),
                "s": _head_np(res.aggs["v_sum"], g).view(np.int64),
                "c": _head_np(res.aggs["v_count"], g)}

    ref = direct()
    t0 = time.perf_counter()
    ref = direct()
    t_direct = time.perf_counter() - t0

    assert np.array_equal(np.sort(out["k"].astype(np.uint32)), ref["k"])
    assert int(out["c"].sum()) == int(ref["c"].sum())
    assert int(out["s"].sum()) == int(ref["s"].sum())

    dev = jax.devices()[0].device_kind
    print(json.dumps({
        "metric": f"SQL filter+GROUP BY {n} rows -> {groups} groups",
        "value": round(n / t_sql), "unit": "rows/s",
        "time_s": round(t_sql, 4),
        "direct_ops_time_s": round(t_direct, 4),
        "frontend_overhead_pct": round(100 * (t_sql - t_direct)
                                       / max(t_direct, 1e-9), 2),
        "device": dev}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
