#!/usr/bin/env python
"""End-to-end analytics walkthrough on the tpu_qe query engine.

A miniature star-schema workload over spatial event data, exercising the
whole operator surface on one device (every step is the same machinery
the engine runs at 100M-1B rows):

  1. morton-encode event coordinates into u64 spatial cell keys
  2. filter events by a predicate (stable compaction)
  3. FK-join events against a dimension table (scan join)
  4. GROUP BY spatial cell with count/sum/mean aggregates
  5. top-k hottest cells
  6. (optional, multi-device) the same sort distributed over a mesh

Run: python examples/analytics.py [--n 1000000]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    args = ap.parse_args()

    import jax.numpy as jnp

    from tpu_qe import morton
    from tpu_qe.table import Table

    n = args.n
    rng = np.random.default_rng(7)

    # --- 1. events: positions + a sensor id + a measurement --------------
    x = rng.uniform(-100, 100, n).astype(np.float32)
    y = rng.uniform(-100, 100, n).astype(np.float32)
    z = rng.uniform(-100, 100, n).astype(np.float32)
    sensor = rng.integers(0, 1024, n).astype(np.uint64)
    value = rng.integers(1, 100, n, dtype=np.uint32)

    params = morton.MortonParams.for_scene(
        np.array([-100.0] * 3, np.float32),
        np.array([100.0] * 3, np.float32))
    fine = morton.encode_points(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(z), params)
    # coarsen to the top 12 key bits (~coarse spatial bucket) so cells
    # hold many events — morton keys nest, so masking IS spatial coarsening
    from tpu_qe.bits import U64
    cell = U64(jnp.zeros_like(fine.lo), fine.hi & jnp.uint32(0xFFF00000))
    coarse = Table({
        "cell": cell, "value": jnp.asarray(value),
        "sensor": Table.from_numpy({"s": sensor})["s"],
    })

    # --- 2. filter: keep high-value events -------------------------------
    filtered, kept = coarse.filter(lambda t: t["value"] > jnp.uint32(20))
    kept = int(kept)
    print(f"filter:   {kept}/{n} events kept")

    # --- 3. join: attach sensor calibration from a dimension table -------
    sensors = Table.from_numpy({
        "sensor": np.arange(1024, dtype=np.uint64),
        "gain": np.arange(1024, dtype=np.uint32) % 7 + 1,
    })
    joined, matched = filtered.head(kept).join(sensors, key="sensor")
    assert bool(jnp.all(matched))
    print(f"join:     all {kept} events matched a sensor")

    # --- 4. GROUP BY spatial cell ----------------------------------------
    res = joined.group_by("cell", value="gain", aggs=("count", "sum", "mean"))
    g = int(res.num_groups)
    print(f"group_by: {g} occupied cells; "
          f"mean gain of first cell = {float(np.asarray(res.aggs['mean'])[0]):.3f}")

    # --- 5. top-k: densest cells (count packed into a sortable u64 key) --
    cnt = res.aggs["count"]
    cells = Table({"key": U64(cnt, jnp.zeros_like(cnt)),
                   "cell_hi": res.key.hi}).head(g)
    top = cells.top_k(5, largest=True)
    print("top_k:    densest cells hold",
          top.table.to_numpy()["key"][:5].tolist(), "events")

    # --- 6. fused join -> GROUP BY via the key-sorted stream -------------
    # the join's natural output is the merged key-sorted stream;
    # aggregating it directly (group_aggregate_sorted) skips both the
    # join restore sort and the aggregate's own key sort — two of the
    # four large sorts of the unfused pipeline. Integer sums are exact
    # u64 pairs.
    from tpu_qe.ops.aggregate import group_aggregate_sorted
    from tpu_qe.ops.join import join_fk_scan

    ev = filtered.head(kept)
    st = join_fk_scan(Table({"z": jnp.zeros(ev.num_rows, jnp.uint32)}),
                      sensors.drop("sensor"),
                      ev["sensor"], sensors["sensor"], output="stream")
    agg = group_aggregate_sorted(st.key, st.values["gain"],
                                 aggs=("count", "sum"), valid=st.matched)
    ng = int(agg.num_groups)
    total = int(agg.aggs["sum"].to_numpy()[:ng].sum())
    gains = np.arange(1024, dtype=np.uint64) % 7 + 1
    want = int(gains[ev.to_numpy()["sensor"]].sum())
    assert total == want, (total, want)
    print(f"fused:    join+GROUP BY sensor in one sorted stream -> "
          f"{ng} sensors, total gain {total} (exact u64, verified)")

    # --- 7. distributed: same sort over every local device ---------------
    from tpu_qe.exchange import distributed_sort_numpy, make_mesh
    mesh = make_mesh()
    d = mesh.shape["x"]
    keys = fine.to_numpy()[: (n // d) * d]
    skeys = distributed_sort_numpy(keys, None, mesh,
                                   capacity_factor="auto")
    assert (np.sort(keys) == skeys).all()
    print(f"dsort:    {len(keys)} keys globally sorted over {d} device(s)")

    # --- 8. out-of-core: GROUP BY more rows than one program sorts -------
    # (miniature shapes here; the same call aggregates 1B rows on a chip
    # — run-partial tables + one combine, exact u64 sums, device-verified)
    from tpu_qe.ops.bigagg import aggregate_big
    res = aggregate_big(1 << 16, n_groups=1 << 10, run_size=1 << 14,
                        minmax=True)
    assert res.all_ok, res
    print(f"bigagg:   {res.n} rows -> {res.n_groups} groups across "
          f"{res.n // (1 << 14)} out-of-core runs (count/sum/min/max "
          f"verified on device)")

    # --- 9. window functions: per-sensor running analytics ---------------
    # OVER (PARTITION BY sensor ORDER BY value): one sort + segmented
    # sweeps; the running sum is an exact u64 pair (never wraps)
    win = ev.window("sensor", {"seq": ("row_number",),
                               "cum_val": ("running_sum", "value"),
                               "prev_val": ("lag", "value")},
                    order="value")
    w = win.to_numpy()
    s0 = w["sensor"] == w["sensor"][0]
    assert w["cum_val"][s0].max() == w["value"][s0].astype(np.uint64).sum()
    print(f"window:   per-sensor row_number/running-sum/lag over "
          f"{win.num_rows} rows ({int(w['seq'].max())} rows in the "
          f"busiest sensor)")

    # --- 10. ORDER BY sensor, value DESC (multi-column, mixed direction) -
    srt = ev.order_by("sensor", ("value", "desc")).to_numpy()
    same_sensor = srt["sensor"][1:] == srt["sensor"][:-1]
    assert (srt["value"][1:][same_sensor]
            <= srt["value"][:-1][same_sensor]).all()
    print(f"order_by: {ev.num_rows} rows by (sensor ASC, value DESC) in "
          f"one lexicographic sort")

    # --- 11. COUNT(DISTINCT value) + exact per-sensor median -------------
    cd = ev.group_by("sensor", "value", aggs=("count", "count_distinct"))
    ncd = int(cd.num_groups)
    qres = ev.group_quantile("sensor", "value", [0.5, 0.99])
    evn = ev.to_numpy()
    klo0 = int(np.asarray(cd.key.lo)[0])
    sel = evn["sensor"] == klo0
    assert (int(np.asarray(cd.aggs["count_distinct"])[0])
            == len(np.unique(evn["value"][sel])))
    med0 = int(np.asarray(qres.quantiles)[0, 0])
    sv = np.sort(evn["value"][sel])
    assert med0 == sv[(len(sv) + 1) // 2 - 1]
    print(f"distinct: COUNT(DISTINCT value) + exact p50/p99 per sensor "
          f"({ncd} sensors; both verified vs numpy on sensor {klo0})")

    # --- 12. set algebra: sensors active in BOTH halves of the stream ----
    half = ev.num_rows // 2
    first = Table({"key": U64(ev["sensor"].lo[:half],
                              ev["sensor"].hi[:half])})
    second = Table({"key": U64(ev["sensor"].lo[half:],
                               ev["sensor"].hi[half:])})
    ikeys, ica, icb, inum = first.set_op(second, "intersect")
    s1 = set(evn["sensor"][:half].tolist())
    s2 = set(evn["sensor"][half:].tolist())
    assert int(inum) == len(s1 & s2)
    print(f"set_op:   {int(inum)} sensors active in both stream halves "
          f"(INTERSECT, verified vs python sets)")

    # --- 13. SQL: the declarative front door to the same machinery -------
    from tpu_qe.sql import Database
    db = Database()
    db.register("events", Table({"sensor": ev["sensor"].lo,
                                 "value": ev["value"]}))
    rows = db.sql(
        "SELECT sensor, COUNT(*) AS c, SUM(value) AS s, "
        "MEDIAN(value) AS med FROM events WHERE value > 50 "
        "GROUP BY sensor HAVING COUNT(*) > 2 ORDER BY s DESC LIMIT 5")
    assert len(rows["sensor"]) <= 5 and (rows["c"] > 2).all()
    print(f"sql:      WHERE + GROUP BY + MEDIAN + HAVING + ORDER BY "
          f"LIMIT -> top {len(rows['sensor'])} sensors by filtered "
          f"gain sum")

    # --- 14. SQL out-of-core: a virtual table bigger than one program ----
    # (miniature; chip_smoke.py runs the same call at 1B rows)
    import jax.numpy as jnp2
    from tpu_qe.hashing import murmur_fmix32
    db.register_virtual("big", (1 << 16) + 17, {
        "k": lambda i: murmur_fmix32(i) & jnp2.uint32(255),
        "v": lambda i: i,
    })
    rows = db.sql("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM big "
                  "GROUP BY k", run_size=1 << 14)
    nbig = (1 << 16) + 17
    assert int(rows["c"].sum()) == nbig
    assert int(rows["s"].astype(np.uint64).sum()) == nbig * (nbig - 1) // 2
    print(f"bigsql:   out-of-core SQL GROUP BY over a {nbig}-row "
          f"virtual table ({len(rows['k'])} groups; closed-form "
          f"verified)")
    print("done.")


if __name__ == "__main__":
    main()
