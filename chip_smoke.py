#!/usr/bin/env python
"""Smoke run of the engine's main path on a GPU, checked against plain references.

    python chip_smoke.py               # phases A-D on one card
    python chip_smoke.py --four-cards  # only the mesh path, on four cards

Phases (one card):

  A  morton LBVH key sort: ``pipeline.sorted_morton_index`` (morton.encode +
     sort_u64 with the xla_tiebreak backend, as ``python -m tpu_qe verify``
     runs it) over a seeded scene, against ``native.pipeline_oracle``,
     bit-exact in keys and in payload order.
  B  in-core SQL: ``Database.register`` + ``Database.sql``, five queries
     against numpy references written here, independently of the engine.
  C  out-of-core SQL GROUP BY over a virtual table (``register_virtual``, the
     bench-bigsql path) against its closed form.
  D  the tests marked ``gpu``, run in this process.

``--four-cards`` runs ``distributed_sort`` and ``Database.sql(mesh=...)``
over a four-device mesh, and nothing else.

Each phase prints one line: its sizes, the steady wall time (a second call
after a warm-up, ended by ``jax.block_until_ready``), the compile time of the
first call (JAX's own compile events), the first device's memory over the
phase (``PhaseMemory``) and the comparison. The sizes are fixed: a phase that
ever has to be cut changes its constant here and says so on its own line. The last line is one JSON object whose ``ok`` is true only
if every phase passed. The script exits non-zero with ``"ok": false`` when
the first device is not a GPU, or when any phase fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Sizes: what this engine's users run (bench.py's default sort,
# tools/bench_sql.py's fact table, the bench-bigsql CLI defaults).
SORT_LOG2_TRIANGLES = 26          # over half as many vertices
FACT_LOG2_ROWS = 27
DIM_LOG2_KEYS = 20
BIG_LOG2_ROWS = 30
BIG_LOG2_GROUPS = 16
BIG_LOG2_RUN = 26
MESH_LOG2_ROWS = 28
MESH_ZIPF = 1.1
SEED = 7
# AVG(f) of f32 values: the device sums in another order than numpy's
# float64 reference, and in f32. Per group (~128 values in [0, 1)) the
# rounding error is far below this.
AVG_RTOL = 1e-4


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class CompileClock:
    """Sums JAX's tracing, lowering and backend-compile events inside its
    ``with`` block; its listener is registered only for that block."""

    def __init__(self):
        self.seconds = 0.0

    def _on_event(self, event, duration, **_):
        if event in _COMPILE_EVENTS:
            self.seconds += duration

    def __enter__(self):
        import jax.monitoring
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)
        return self

    def __exit__(self, *exc):
        import jax.monitoring
        jax.monitoring.unregister_event_duration_listener(self._on_event)


def _memory_stats() -> dict | None:
    import jax
    return jax.devices()[0].memory_stats()


class PhaseMemory:
    """Device memory of one phase, from the first device's allocator.

    The allocator's ``peak_bytes_in_use`` never resets, so it is this
    phase's peak only when the phase raised it (``phase_peak_exact``).
    Otherwise ``phase_peak_bytes`` is the largest ``bytes_in_use`` a thread
    sampled every millisecond until ``stop_sampling``: a lower bound.
    ``fields`` is empty where the backend keeps no statistics (the CPU)."""

    SAMPLE_S = 0.001

    def __init__(self):
        self.fields: dict = {}
        self._stop = threading.Event()
        self._thread = None

    def __enter__(self):
        s = _memory_stats()
        self._stats = s is not None
        if self._stats:
            self._before = int(s["bytes_in_use"])
            self._peak0 = int(s["peak_bytes_in_use"])
            self._sampled = self._before
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(self.SAMPLE_S):
            self._sampled = max(self._sampled,
                                int(_memory_stats()["bytes_in_use"]))

    def stop_sampling(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def __exit__(self, *exc):
        self.stop_sampling()
        if not self._stats:
            return
        s = _memory_stats()
        after, peak = int(s["bytes_in_use"]), int(s["peak_bytes_in_use"])
        exact = peak > self._peak0
        self.fields = {"bytes_in_use_before": self._before,
                       "bytes_in_use_after": after,
                       "phase_peak_bytes": peak if exact
                       else max(self._sampled, after),
                       "phase_peak_exact": exact}


def warm_and_time(fn, clock: CompileClock
                  ) -> tuple[object, float, float, dict]:
    """(result, steady seconds, compile seconds, memory fields): fn runs
    once to warm up (its compile time is taken from JAX's events, its
    device memory sampled), then once timed with no sampling."""
    import jax
    with PhaseMemory() as mem:
        with clock:
            jax.block_until_ready(fn())
        mem.stop_sampling()
        compile_s = clock.seconds
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        wall = time.perf_counter() - t0
    return out, wall, compile_s, mem.fields


def sort_lowering(hlo_text: str) -> dict:
    """Which sort XLA chose: CUB custom calls vs its own sort instructions."""
    import re
    targets = re.findall(r'custom_call_target="([^"]*)"', hlo_text)
    return {"cub_calls": sum("cub" in t.lower() for t in targets),
            "xla_sort_ops": len(re.findall(r"\bsort\(", hlo_text))}


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip() or f"nvidia-smi rc {r.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# data and numpy references (independent of tpu_qe)
# ---------------------------------------------------------------------------

def make_tables(n_fact: int, n_dim: int, seed: int = SEED,
                zipf: float | None = None, signed: bool = True) -> tuple:
    """Seeded star pair. Fact: k u32 FK into the dimension's keys (uniform,
    or Zipf-ranked), v i32, f f32, id u32 row index. Dimension: unique dk,
    g = dk & 1023 (1024 groups), w u32."""
    rng = np.random.default_rng(seed)
    dk = rng.permutation(n_dim).astype(np.uint32)
    if zipf is None:
        k = rng.integers(0, n_dim, n_fact, dtype=np.uint32)
    else:
        k = dk[(rng.zipf(zipf, n_fact) - 1) % n_dim]
    lo = 0 if not signed else -(1 << 20)
    fact = {"k": k,
            "v": rng.integers(lo, 1 << 20, n_fact, dtype=np.int32),
            "f": rng.random(n_fact, dtype=np.float32),
            "id": np.arange(n_fact, dtype=np.uint32)}
    dim = {"dk": dk, "g": dk & np.uint32(1023),
           "w": rng.integers(0, 1000, n_dim, dtype=np.uint32)}
    return fact, dim


def _bincount(keys, n, weights=None):
    return np.bincount(keys, weights=weights, minlength=n)


def ref_group_where(fact: dict, n_dim: int) -> dict:
    """(i) SELECT k, COUNT(*), SUM(v), AVG(f) WHERE v % 4 <> 0 GROUP BY k."""
    m = (fact["v"] % 4) != 0
    k = fact["k"][m]
    c = _bincount(k, n_dim)
    s = _bincount(k, n_dim, fact["v"][m].astype(np.float64))
    fs = _bincount(k, n_dim, fact["f"][m].astype(np.float64))
    keep = np.flatnonzero(c)
    return {"k": keep.astype(np.uint32), "c": c[keep].astype(np.int64),
            "s": s[keep].astype(np.int64), "af": fs[keep] / c[keep]}


def ref_join_having(fact: dict, dim: dict, thr: int, limit: int) -> dict:
    """(ii) JOIN d ON k = dk, GROUP BY g HAVING COUNT(*) > thr,
    ORDER BY s DESC, g LIMIT limit."""
    g_of = np.zeros(len(dim["dk"]), np.int64)
    g_of[dim["dk"]] = dim["g"]
    g = g_of[fact["k"]]
    c = _bincount(g, 1024).astype(np.int64)
    s = _bincount(g, 1024, fact["v"].astype(np.float64)).astype(np.int64)
    keep = np.flatnonzero(c > thr)
    order = np.lexsort((keep, -s[keep]))[:limit]
    sel = keep[order]
    return {"g": sel.astype(np.uint32), "c": c[sel], "s": s[sel]}


def ref_window(fact: dict) -> dict:
    """(iii) ROW_NUMBER and running SUM(v) OVER (PARTITION BY k ORDER BY id),
    indexed by id (ids are the row positions)."""
    order = np.argsort(fact["k"], kind="stable")   # id order within k
    ks = fact["k"][order]
    n = len(ks)
    start = np.ones(n, bool)
    start[1:] = ks[1:] != ks[:-1]
    first = np.maximum.accumulate(np.where(start, np.arange(n), 0))
    cs = np.cumsum(fact["v"][order].astype(np.int64))
    base = np.where(first > 0, cs[first - 1], 0)
    rn = np.empty(n, np.int64)
    rs = np.empty(n, np.int64)
    rn[order] = np.arange(n) - first + 1
    rs[order] = cs - base
    return {"rn": rn, "rs": rs}


def ref_order_limit(fact: dict, limit: int) -> dict:
    """(iv) ORDER BY k DESC, v, id LIMIT limit."""
    k = fact["k"]
    kth = np.partition(k, len(k) - limit)[len(k) - limit]
    cand = np.flatnonzero(k >= kth)
    order = cand[np.lexsort((fact["id"][cand], fact["v"][cand],
                             -k[cand].astype(np.int64)))][:limit]
    return {c: fact[c][order] for c in ("id", "k", "v")}


def ref_percentile_disc(fact: dict, n_dim: int, q: float) -> dict:
    """(v) PERCENTILE_DISC(q) WITHIN GROUP (ORDER BY v) GROUP BY k: the
    smallest v whose cumulative share in its group reaches q."""
    packed = ((fact["k"].astype(np.uint64) << np.uint64(32))
              | (fact["v"].astype(np.int64) + (1 << 31)).astype(np.uint64))
    packed.sort()
    c = _bincount(fact["k"], n_dim)
    keep = np.flatnonzero(c)
    start = np.concatenate([[0], np.cumsum(c)[:-1]])[keep]
    r = np.clip(np.ceil(q * c[keep]).astype(np.int64) - 1, 0, c[keep] - 1)
    v = ((packed[start + r] & np.uint64(0xFFFFFFFF)).astype(np.int64)
         - (1 << 31))
    return {"k": keep.astype(np.uint32), "p": v.astype(np.int32)}


def _sorted_by(out: dict, key: str) -> dict:
    o = np.argsort(np.asarray(out[key]), kind="stable")
    return {c: np.asarray(v)[o] for c, v in out.items()}


def _same_ints(got: dict, want: dict, cols) -> bool:
    return all(len(got[c]) == len(want[c]) and np.array_equal(
        np.asarray(got[c]).astype(np.int64),
        np.asarray(want[c]).astype(np.int64)) for c in cols)


# ---------------------------------------------------------------------------
# SQL queries (shared by phase B, the four-card phase and the tests)
# ---------------------------------------------------------------------------

def sql_queries(n_fact: int) -> dict:
    thr = n_fact // 1024       # about half of the 1024 dimension groups
    return {
        "i_group_where":
            "SELECT k, COUNT(*) AS c, SUM(v) AS s, AVG(f) AS af FROM t "
            "WHERE v % 4 <> 0 GROUP BY k",
        "ii_join_having":
            "SELECT d.g AS g, COUNT(*) AS c, SUM(t.v) AS s FROM t "
            "JOIN d ON t.k = d.dk GROUP BY d.g "
            f"HAVING COUNT(*) > {thr} ORDER BY s DESC, g LIMIT 10",
        "iii_window":
            "SELECT id, ROW_NUMBER() OVER (PARTITION BY k ORDER BY id) "
            "AS rn, SUM(v) OVER (PARTITION BY k ORDER BY id) AS rs FROM t",
        "iv_order_limit":
            "SELECT id, k, v FROM t ORDER BY k DESC, v, id LIMIT 100",
        "v_percentile":
            "SELECT k, PERCENTILE_DISC(0.9) WITHIN GROUP (ORDER BY v) AS p "
            "FROM t GROUP BY k",
    }


def check_query(name: str, out: dict, fact: dict, dim: dict) -> str | None:
    """None when out equals the numpy reference, else what differs."""
    n_dim = len(dim["dk"])
    if name == "i_group_where":
        want, got = ref_group_where(fact, n_dim), _sorted_by(out, "k")
        if not _same_ints(got, want, ("k", "c", "s")):
            return "k/c/s differ"
        if not np.allclose(got["af"], want["af"], rtol=AVG_RTOL, atol=0):
            return "AVG(f) outside rtol"
        return None
    if name == "ii_join_having":
        want = ref_join_having(fact, dim, len(fact["k"]) // 1024, 10)
        return None if _same_ints(out, want, ("g", "c", "s")) else \
            "rows differ"
    if name == "iii_window":
        want = ref_window(fact)
        ids = np.asarray(out["id"]).astype(np.int64)
        if len(ids) != len(fact["id"]) or not np.array_equal(
                np.sort(ids), np.arange(len(ids))):
            return "ids are not a permutation of the rows"
        ok = (np.array_equal(np.asarray(out["rn"]).astype(np.int64),
                             want["rn"][ids])
              and np.array_equal(np.asarray(out["rs"]).astype(np.int64),
                                 want["rs"][ids]))
        return None if ok else "rn/rs differ"
    if name == "iv_order_limit":
        want = ref_order_limit(fact, 100)
        return None if _same_ints(out, want, ("id", "k", "v")) else \
            "rows differ"
    if name == "v_percentile":
        want, got = ref_percentile_disc(fact, n_dim, 0.9), \
            _sorted_by(out, "k")
        return None if _same_ints(got, want, ("k", "p")) else \
            "percentiles differ"
    raise KeyError(name)


# ---------------------------------------------------------------------------
# phases: each returns a list of result lines (dicts with "ok")
# ---------------------------------------------------------------------------

def phase_sort(log2_tris: int, clock: CompileClock) -> list[dict]:
    """A: morton encode + tiebreak sort vs the C++ pipeline oracle."""
    import jax.numpy as jnp

    from tpu_qe import morton, native, pipeline

    n_tri, n_vert = 1 << log2_tris, 1 << (log2_tris - 1)
    verts, tris, smin, smax = native.scene_generate(n_vert, n_tri, SEED)
    params = morton.MortonParams.for_scene(smin, smax)
    vd, td = jnp.asarray(verts), jnp.asarray(tris.astype(np.int32))
    del verts, tris

    def run():
        return pipeline.sorted_morton_index(vd, td, params)

    res, wall, comp, mem = warm_and_time(run, clock)
    lowering = sort_lowering(
        pipeline.sorted_morton_index.lower(vd, td, params).compile().as_text())
    keys = res.code.to_numpy()
    order = np.asarray(res.order)
    del res, vd, td
    want_keys, want_order = native.pipeline_oracle(n_vert, n_tri, SEED)
    keys_exact = bool(np.array_equal(keys, want_keys))
    order_exact = bool(np.array_equal(order, want_order))
    return [{"phase": "A_morton_sort", "triangles": n_tri,
             "vertices": n_vert, "seconds": wall, "compile_s": comp,
             "keys_per_s": n_tri / wall, "sort_lowering": lowering,
             "keys_bit_exact": keys_exact, "order_bit_exact": order_exact,
             **mem, "ok": keys_exact and order_exact}]


def phase_sql(log2_fact: int, log2_dim: int, clock: CompileClock
              ) -> list[dict]:
    """B: five in-core queries vs the numpy references."""
    from tpu_qe.sql import Database

    n_fact, n_dim = 1 << log2_fact, 1 << log2_dim
    fact, dim = make_tables(n_fact, n_dim)
    db = Database()
    db.register("t", fact)
    db.register("d", dim)
    lines = []
    for name, sql in sql_queries(n_fact).items():
        out, wall, comp, mem = warm_and_time(lambda: db.sql(sql), clock)
        err = check_query(name, out, fact, dim)
        lines.append({"phase": f"B_sql_{name}", "fact_rows": n_fact,
                      "dim_rows": n_dim, "seconds": wall, "compile_s": comp,
                      "rows_per_s": n_fact / wall, "out_rows":
                      len(next(iter(out.values()))), **mem,
                      "ok": err is None, "mismatch": err})
    return lines


def phase_bigsql(log2_rows: int, log2_groups: int, log2_run: int,
                 clock: CompileClock) -> list[dict]:
    """C: out-of-core GROUP BY over a virtual table vs its closed form:
    k = fmix32(i) & (G-1), v = i, so the counts sum to n, SUM(v) totals
    n(n-1)/2, MIN is 0, MAX is n-1 and all G groups appear."""
    import jax.numpy as jnp

    from tpu_qe.sql import Database

    n, g = 1 << log2_rows, 1 << log2_groups
    run = 1 << min(log2_run, log2_rows)

    def fmix32(h):
        for shift, mul in ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, None)):
            h = h ^ (h >> jnp.uint32(shift))
            if mul is not None:
                h = h * jnp.uint32(mul)
        return h

    db = Database()
    db.register_virtual("big", n, {
        "k": lambda i: fmix32(i) & jnp.uint32(g - 1),
        "v": lambda i: i})
    sql = ("SELECT k, COUNT(*) AS c, SUM(v) AS s, MIN(v) AS mn, "
           "MAX(v) AS mx FROM big GROUP BY k")
    out, wall, comp, mem = warm_and_time(
        lambda: db.sql(sql, run_size=run, max_groups=g), clock)
    ok = (int(np.asarray(out["c"]).astype(np.int64).sum()) == n
          and int(np.asarray(out["s"]).astype(np.uint64).sum(
              dtype=np.uint64)) == n * (n - 1) // 2
          and int(np.min(out["mn"])) == 0
          and int(np.max(out["mx"])) == n - 1
          and np.array_equal(np.sort(np.asarray(out["k"])),
                             np.arange(g, dtype=np.uint32)))
    return [{"phase": "C_bigsql_groupby", "rows": n, "groups": g,
             "run_size": run, "seconds": wall, "compile_s": comp,
             "rows_per_s": n / wall, **mem, "ok": bool(ok)}]


def phase_gpu_tests(clock: CompileClock) -> list[dict]:
    """D: the tests marked gpu, in this process (one process per card)."""
    import pytest

    class Count:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1

    counter = Count()
    # tests/conftest.py keeps the CPU unless JAX_PLATFORMS names another
    # platform; this process already holds the GPU
    os.environ["JAX_PLATFORMS"] = "cuda"
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[counter])
    return [{"phase": "D_gpu_tests", "seconds": time.perf_counter() - t0,
             "passed": counter.passed, "failed": counter.failed,
             "ok": int(rc) == 0 and counter.passed > 0
             and counter.failed == 0}]


def phase_mesh_sort(log2_rows: int, mesh, clock: CompileClock) -> list[dict]:
    """Four cards: distributed_sort of u64 keys + u32 payload vs a stable
    numpy argsort; also where each device's run lives."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_qe.bits import U64
    from tpu_qe.exchange.dsort import auto_capacity, distributed_sort

    n = 1 << log2_rows
    n_dev = mesh.devices.size
    rng = np.random.default_rng(SEED)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys[::7] = keys[0]                      # duplicates: stability shows
    shard = NamedSharding(mesh, P("x"))
    k = U64.from_numpy(keys)
    key = U64(jax.device_put(k.lo, shard), jax.device_put(k.hi, shard))
    pay = jax.device_put(np.arange(n, dtype=np.uint32), shard)
    cap = auto_capacity(key, mesh)

    def run():
        return distributed_sort(key, pay, mesh=mesh, capacity=cap)

    (res, overflow), wall, comp, mem = warm_and_time(run, clock)
    placement = sorted({str(s.device) for s in res.key.lo.addressable_shards})
    valid = np.asarray(res.valid).reshape(n_dev)
    lo = np.asarray(res.key.lo).reshape(n_dev, -1)
    hi = np.asarray(res.key.hi).reshape(n_dev, -1)
    p = np.asarray(res.payloads[0]).reshape(n_dev, -1)
    got_k = np.concatenate([lo[d, :valid[d]].astype(np.uint64)
                            | (hi[d, :valid[d]].astype(np.uint64)
                               << np.uint64(32)) for d in range(n_dev)])
    got_p = np.concatenate([p[d, :valid[d]] for d in range(n_dev)])
    order = np.argsort(keys, kind="stable")
    ok = (int(np.asarray(overflow).max()) == 0
          and np.array_equal(got_k, keys[order])
          and np.array_equal(got_p, order.astype(np.uint32))
          and len(placement) == n_dev)
    return [{"phase": "M_distributed_sort", "rows": n, "devices": n_dev,
             "seconds": wall, "compile_s": comp, "keys_per_s": n / wall,
             "rows_per_device": valid.tolist(), "placement": placement,
             **mem, "ok": bool(ok)}]


def mesh_queries(n_fact: int) -> dict:
    """Queries (i) and (ii) in the shapes the mesh tier takes: its fused
    join groups by the left join key and has no HAVING."""
    return {
        "i_group_where": sql_queries(n_fact)["i_group_where"],
        "ii_join_order_limit":
            "SELECT t.k AS k, COUNT(*) AS c, SUM(d.w) AS s FROM t "
            "JOIN d ON t.k = d.dk GROUP BY t.k ORDER BY c DESC, k LIMIT 100",
    }


def ref_mesh_join(fact: dict, dim: dict, limit: int) -> dict:
    n_dim = len(dim["dk"])
    w_of = np.zeros(n_dim, np.float64)
    w_of[dim["dk"]] = dim["w"]
    c = _bincount(fact["k"], n_dim).astype(np.int64)
    s = _bincount(fact["k"], n_dim, w_of[fact["k"]]).astype(np.int64)
    keep = np.flatnonzero(c)
    sel = keep[np.lexsort((keep, -c[keep]))][:limit]
    return {"k": sel.astype(np.uint32), "c": c[sel], "s": s[sel]}


def phase_mesh_sql(log2_fact: int, log2_dim: int, mesh,
                   clock: CompileClock) -> list[dict]:
    """Four cards: Database.sql(mesh=) over a Zipf(1.1) fact table."""
    from tpu_qe.sql import Database

    n_fact, n_dim = 1 << log2_fact, 1 << log2_dim
    fact, dim = make_tables(n_fact, n_dim, zipf=MESH_ZIPF, signed=False)
    db = Database()
    db.register("t", fact)
    db.register("d", dim)
    lines = []
    for name, sql in mesh_queries(n_fact).items():
        out, wall, comp, mem = warm_and_time(
            lambda: db.sql(sql, mesh=mesh), clock)
        if name == "i_group_where":
            err = check_query(name, out, fact, dim)
        else:
            err = None if _same_ints(out, ref_mesh_join(fact, dim, 100),
                                     ("k", "c", "s")) else "rows differ"
        hot = float(np.bincount(fact["k"]).max() / n_fact)
        lines.append({"phase": f"M_sql_{name}", "fact_rows": n_fact,
                      "dim_rows": n_dim, "zipf": MESH_ZIPF,
                      "hottest_key_share": hot,
                      "devices": int(mesh.devices.size), "seconds": wall,
                      "compile_s": comp, "rows_per_s": n_fact / wall,
                      **mem, "ok": err is None, "mismatch": err})
    return lines


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def run_phases(phases) -> bool:
    """Run each (name, thunk); print one line per result. A phase that
    raises is a failed phase; the rest still run."""
    ok = True
    for name, thunk in phases:
        try:
            lines = thunk()
        except Exception as e:  # a phase's failure is reported, not hidden
            traceback.print_exc()
            lines = [{"phase": name, "ok": False,
                      "error": f"{type(e).__name__}: {e}"[:500]}]
        for line in lines:
            print(json.dumps(line), flush=True)
            ok = ok and bool(line["ok"])
        gc.collect()
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh path, on four devices")
    args = ap.parse_args(argv)
    want = 4 if args.four_cards else 1
    result = {"ok": False}
    try:
        import jax
        devs = jax.devices()
        result["device"] = {"platform": devs[0].platform,
                            "kind": devs[0].device_kind, "count": len(devs)}
        if devs[0].platform != "gpu":
            raise RuntimeError(f"no GPU: JAX's first device is {devs[0]}")
        if len(devs) < want:
            raise RuntimeError(f"need {want} GPUs, JAX sees {len(devs)}")
        print(json.dumps({"nvidia_smi": nvidia_smi(), "jax": jax.__version__,
                          "devices": [str(d) for d in devs],
                          "x64": bool(jax.config.jax_enable_x64)}),
              flush=True)
        clock = CompileClock()
        if args.four_cards:
            from tpu_qe.exchange.dsort import make_mesh
            mesh = make_mesh(4)
            phases = [
                ("M_distributed_sort",
                 lambda: phase_mesh_sort(MESH_LOG2_ROWS, mesh, clock)),
                ("M_sql", lambda: phase_mesh_sql(
                    MESH_LOG2_ROWS, DIM_LOG2_KEYS, mesh, clock)),
            ]
        else:
            phases = [
                ("A_morton_sort",
                 lambda: phase_sort(SORT_LOG2_TRIANGLES, clock)),
                ("B_sql", lambda: phase_sql(FACT_LOG2_ROWS, DIM_LOG2_KEYS,
                                            clock)),
                ("C_bigsql_groupby", lambda: phase_bigsql(
                    BIG_LOG2_ROWS, BIG_LOG2_GROUPS, BIG_LOG2_RUN, clock)),
                # last: the tests' conftest turns on x64 in this process
                ("D_gpu_tests", lambda: phase_gpu_tests(clock)),
            ]
        ok = run_phases(phases)
        print(nvidia_smi(), flush=True)
        result["ok"] = ok
    except Exception as e:
        traceback.print_exc()
        result["error"] = f"{type(e).__name__}: {e}"[:500]
    print(json.dumps({k: result[k] for k in ("ok", "device", "error")
                      if k in result}), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
