"""Distributed out-of-core GROUP BY: the aggregation composition over a mesh.

Completes the engine's composition matrix for aggregation the way
sort/dbigsort.py did for sorting: data larger than ONE device's
aggregation working set, spread over a jax.sharding.Mesh, reduced by a
two-level combine tree in which every level is the SAME verified merge
(ops/bigagg.py::_merge_partials):

  phase A   every device simultaneously partial-aggregates run r of its
            local rows in one shard_map program (global row index
            d*n_local + r*run_size + lane — regenerable; no host
            streaming, see sort/bigsort.py). Only
            sentinel-padded partial group tables survive each run.
  phase B   one shard_map program: each device merges its R partial
            tables locally (groups collapse to <= min(G, n_local) rows —
            aggregation IS compression), all_gathers the D compacted
            local tables (the ONLY cross-device traffic:
            D * local_cap * 20-28 B), and merges + verifies the
            replicated global table. Every device holds the identical
            result, checked by the same closed forms as the single-chip
            path (count total n, u64 value total n(n-1)/2, strict key
            uniqueness, min/max bounds).

Why all_gather and not a keyed all_to_all: after local aggregation the
tables are G-bounded — tiny next to the raw rows — so replicating them
costs less than planning a key-ranged exchange, and the replicated
combine needs no capacity planning at all (the structural bound
local_cap >= distinct-local-groups is exact, not sampled). A key-range
all_to_all combine (each device owning a splitter range, the
exchange/dops.py recipe) becomes the right shape only when G itself
exceeds one device's memory — asserted, not silently wrong, like
bigagg's in-core combine cap.

Reference contrast: the reference is single-device with no aggregation;
this is SURVEY.md §2c's mandated communication layer carrying §7 step
6's GROUP BY past both the single-program and the single-device limits.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_qe.exchange.shuffle import AXIS
from tpu_qe.ops.bigagg import (BigAggResult, _aggregate_rows, _host_table,
                               _merge_partials, _verify_and_emit, _ONES)


def _runner_fn(mesh: Mesh, n_local: int, run_size: int, n_groups: int,
               seed: int, partial_cap: int, minmax: bool):
    """Phase-A program: every device partial-aggregates ITS run r."""

    def body(r):
        d = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        base = d * jnp.uint32(n_local) + r * jnp.uint32(run_size)
        idx = base + jnp.arange(run_size, dtype=jnp.uint32)
        return _aggregate_rows(idx, n_groups, seed, partial_cap, minmax)

    ncols = 7 if minmax else 5
    fn = shard_map(body, mesh=mesh, in_specs=(P(),),
                   out_specs=tuple([P(AXIS)] * ncols), check_vma=False)
    return jax.jit(fn)


def _combiner_fn(mesh: Mesh, n_runs: int, local_cap: int,
                 minmax: bool, collect: bool):
    """Phase-B program: local merge -> all_gather -> global merge+verify.

    The local_cap static slice after the local merge is safe by
    structure: merged valid rows are compacted to the front and number
    <= min(n_groups, n_runs * partial_cap) == local_cap (a device cannot
    see more distinct groups than keys exist or rows it aggregated)."""
    ncols = 7 if minmax else 5
    idents = (_ONES, _ONES, jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
              _ONES, jnp.uint32(0))

    def body(*flat):
        # flat: n_runs tables x ncols local (partial_cap,) planes
        cols = tuple(
            jnp.concatenate([flat[r * ncols + c] for r in range(n_runs)])
            for c in range(ncols))
        gklo, gkhi, gcnt, gsums, gmn, gmx, gvalid = _merge_partials(cols)
        planes = [gklo, gkhi, gcnt, gsums[0].lo, gsums[0].hi] \
            + ([gmn, gmx] if minmax else [])
        loc = [jnp.where(gvalid, a, idents[c])[:local_cap]
               for c, a in enumerate(planes)]
        gathered = tuple(jax.lax.all_gather(a, AXIS).reshape(-1)
                         for a in loc)
        return _verify_and_emit(_merge_partials(gathered), collect, minmax)

    n_out = 6 + (0 if not collect else (6 if minmax else 4))
    fn = shard_map(body, mesh=mesh,
                   in_specs=tuple([P(AXIS)] * (n_runs * ncols)),
                   out_specs=tuple([P()] * n_out), check_vma=False)
    return jax.jit(fn)


def aggregate_big_distributed(n: int, mesh: Mesh, n_groups: int = 1 << 20,
                              run_size: int = 1 << 26, seed: int = 7,
                              verbose: bool = False, collect: bool = False,
                              minmax: bool = False,
                              force_composed: bool = False,
                              checkpoint_dir: str | None = None):
    """Distributed out-of-core GROUP BY of n generated rows over `mesh`.

    n must be divisible by D * run_size. Row model identical to
    aggregate_big (group = hash(global index) mod n_groups, value =
    global index), so the result table is bit-identical to the
    single-chip path at equal n — asserted by the CPU-mesh tests.

    With D == 1 the combine tree has one leaf, so the call DELEGATES to
    single-chip aggregate_big (same data model, same verification);
    force_composed=True keeps the shard_map machinery at D=1 (identity
    all_gather) for tests. Multi-device runs are validated on the CPU
    mesh.

    Returns BigAggResult; collect=True additionally returns the
    replicated host group table dict (small-n oracle tests only).

    checkpoint_dir: same per-run partial-table persistence contract as
    aggregate_big (the tables ARE the checkpoint); sharded round tables
    are gathered to host for the write and re-placed with their P(AXIS)
    sharding on resume. Opt-in readback cost, like the single-chip path.
    """
    n_dev = int(mesh.shape[AXIS])
    if n_dev == 1 and not force_composed:
        from tpu_qe.ops.bigagg import aggregate_big
        return aggregate_big(n, n_groups=n_groups, run_size=run_size,
                             seed=seed, verbose=verbose, collect=collect,
                             minmax=minmax, checkpoint_dir=checkpoint_dir)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 32), "values travel as u32 global index"
    n_local = n // n_dev
    n_runs = n_local // run_size
    partial_cap = min(n_groups, run_size)
    local_cap = min(n_groups, n_runs * partial_cap)
    assert n_dev * local_cap < (1 << 28), \
        ("replicated combine exceeds the in-core cap; a key-ranged "
         "exchange combine is required at this G (module docstring)",
         n_dev, local_cap)

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    run_exec = _runner_fn(mesh, n_local, run_size, n_groups, seed,
                          partial_cap, minmax)
    run_exec = run_exec.lower(jnp.uint32(0)).compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    if checkpoint_dir is None:
        parts = [run_exec(jnp.uint32(r)) for r in range(n_runs)]
        np.asarray(parts[-1][0][-1:])  # fence after queueing ALL dispatches
    else:
        # per-run partial tables ARE the checkpoint (aggregate_big's
        # contract); sharded planes round-trip through host npz
        from tpu_qe.ops.bigagg import _run_ck_load, _run_ck_save
        meta_ck = np.asarray([n, n_dev, n_groups, run_size, seed,
                              int(minmax)], np.int64)
        sh = NamedSharding(mesh, P(AXIS))
        parts, resumed = [], 0
        for r in range(n_runs):
            part = _run_ck_load(checkpoint_dir, f"d{r}", meta_ck)
            if part is not None:
                part = tuple(jax.device_put(np.asarray(a), sh)
                             for a in part)
                resumed += 1
            else:
                part = run_exec(jnp.uint32(r))
                _run_ck_save(checkpoint_dir, f"d{r}", meta_ck, part)
            parts.append(part)
        if verbose and resumed:
            print(f"dbigagg: resuming — {resumed}/{n_runs} round tables "
                  "loaded from checkpoint")
    t_a = time.perf_counter() - t0

    tcb = time.perf_counter()
    flat = tuple(a for p in parts for a in p)
    comb = _combiner_fn(mesh, n_runs, local_cap, minmax, collect)
    comb_exec = comb.lower(*flat).compile()
    compile_s += time.perf_counter() - tcb

    t1 = time.perf_counter()
    out = comb_exec(*flat)
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
        print(f"dbigagg: n={n} D={n_dev} R={n_runs}/dev G={n_groups} "
              f"local_cap={local_cap} groups={ng} "
              f"A={t_a:.2f}s B={t_b:.2f}s ok={res.all_ok}")
    if collect:
        return res, _host_table(out[6:], minmax)
    return res
