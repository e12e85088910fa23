"""Distributed x out-of-core COUNT(DISTINCT value) GROUP BY key.

Completes the COUNT DISTINCT composition row. Dedup is the compression
at EVERY level (the invariant of ops/bigdistinct.py and
exchange/dops.py's distributed_count_distinct, composed):

  phase A   per device, per run: generate + dedup the run's (key, value)
            pairs on device (sorted pair table + exact occurrence
            counts, bounded by min(run_size, G*V));
  phase L   per device: ONE resident merge of its R partial tables —
            cross-run duplicates collapse in the pair sort, occurrence
            counts survive by summation. A device now holds its shard's
            exact distinct-pair table (bounded by min(n_local, G*V));
  phase R   route the deduped pairs by KEY splitters (every key's pairs
            co-locate — the count is then local and exact) with an
            explicit validity plane, one two-tier exchange; the final
            per-device count dedups once more (pair copies arriving
            from different source devices collapse; their occurrence
            counts sum).

Exchange volume = the locally distinct pairs (12 B each + validity),
never rows. Every overflow (per-run cap, per-device cap, exchange
capacity) is DETECTED exactly; closed-form on-device verification per
group over the structured data model of bigdistinct (group g holds
n//G (+1) rows with min(count, V) distinct values).

Reference contrast: single device, one queue submit
(/root/reference/src/main.rs:727); SURVEY §2c mandates the scaled
composition — applied to the dedup-shaped aggregate.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_qe.exchange.shuffle import (AXIS, exchange, route_by_splitters,
                                     sample_splitters)
from tpu_qe.ops.aggregate import _shift_right_one
from tpu_qe.ops.bigdistinct import count_distinct_big, rows_of_index
from tpu_qe.ops.segscan import cumsum_u32

_ONES = jnp.uint32(0xFFFFFFFF)


def _dedup_sorted(sg, sv, occ_in=None):
    """Boundary-dedup an already (key, value)-sorted pair stream whose
    sentinel pads (key all-ones) sit at the tail; occurrence counts sum
    within each pair run (occ_in None = each row counts 1; pads carry
    occ 0 and key _ONES so they contribute nothing).

    Returns (klo, v, occ, m) with the m distinct pairs compacted to the
    front (pads _ONES / 0 behind)."""
    n = sg.shape[0]
    pos = jnp.arange(n, dtype=jnp.uint32)
    sent = sg == _ONES
    pair_new = (((pos == 0) | (sg != _shift_right_one(sg, 0))
                 | (sv != _shift_right_one(sv, 0))) & ~sent)
    # dtype pinned: x64 (tests) would promote the sum to u64 and break
    # AOT-compiled signatures (see dwindow's identical note)
    m = jnp.sum(pair_new.astype(jnp.uint32), dtype=jnp.uint32)
    occ = occ_in if occ_in is not None \
        else jnp.where(sent, jnp.uint32(0), jnp.uint32(1))
    cum_occ = cumsum_u32(occ)
    pair_end = ~sent & jnp.concatenate(
        [(pair_new | sent)[1:], jnp.ones((1,), bool)])
    pos1 = pos + 1
    packed = jnp.where(pair_end, pos1, pos1 | jnp.uint32(1 << 31))
    res = jax.lax.sort([packed, sg, sv, cum_occ], num_keys=1,
                       is_stable=False)
    ce = res[3]
    occ_out = ce - _shift_right_one(ce, 0)
    valid = pos < m
    return (jnp.where(valid, res[1], _ONES),
            jnp.where(valid, res[2], jnp.uint32(0)),
            jnp.where(valid, occ_out, jnp.uint32(0)), m)


def _runner_fn(mesh: Mesh, n_local: int, run_size: int, n_groups: int,
               n_values: int, partial_cap: int):
    """Phase A: run r on every device — generate, sort, dedup, compact."""

    def body(rr):
        d = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        base = d * jnp.uint32(n_local) + rr[0] * jnp.uint32(run_size)
        idx = base + jnp.arange(run_size, dtype=jnp.uint32)
        g, v = rows_of_index(idx, n_groups, n_values)
        sg, sv = jax.lax.sort([g, v], num_keys=2, is_stable=False)
        klo, val, occ, m = _dedup_sorted(sg, sv)
        cut = functools.partial(jax.lax.slice, start_indices=(0,),
                                limit_indices=(partial_cap,))
        return cut(klo), cut(val), cut(occ), m.reshape(1)

    fn = shard_map(body, mesh=mesh, in_specs=(P(None),),
                   out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
                   check_vma=False)
    return jax.jit(fn)


def _local_combine_fn(mesh: Mesh, n_runs: int, local_cap: int):
    """Phase L: merge a device's R partial pair tables into ONE deduped
    table (occurrences sum across runs)."""

    def body(*cols):
        klo = jnp.concatenate(cols[0::3])
        v = jnp.concatenate(cols[1::3])
        occ = jnp.concatenate(cols[2::3])
        sg, sv, so = jax.lax.sort([klo, v, occ], num_keys=2,
                                  is_stable=False)
        dk, dv, do, m = _dedup_sorted(sg, sv, occ_in=so)
        cut = functools.partial(jax.lax.slice, start_indices=(0,),
                                limit_indices=(local_cap,))
        ovf = (m > jnp.uint32(local_cap)).astype(jnp.uint32)
        return cut(dk), cut(dv), cut(do), m.reshape(1), ovf.reshape(1)

    specs = tuple([P(AXIS)] * (3 * n_runs))
    fn = shard_map(body, mesh=mesh, in_specs=specs,
                   out_specs=tuple([P(AXIS)] * 5), check_vma=False)
    return jax.jit(fn)


def _route_count_fn(mesh: Mesh, n_dev: int, samples_per_dev: int,
                    capacity: int, n: int, n_groups: int, n_values: int,
                    collect: bool):
    """Phase R: splitter-route the deduped pairs by key, count distinct
    + sum occurrences per key locally, verify the closed form."""

    def body(klo, v, occ, m_arr):
        m_loc = m_arr[0]
        is_real = jnp.arange(klo.shape[0], dtype=jnp.uint32) < m_loc
        khi = jnp.zeros_like(klo)
        kl = jnp.where(is_real, klo, _ONES)
        kh = jnp.where(is_real, khi, _ONES)
        sp_lo, sp_hi = sample_splitters(kl, kh, n_dev, samples_per_dev,
                                        n_valid=m_loc)
        my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        dest = route_by_splitters(kl, kh, sp_lo, sp_hi)
        dest = jnp.where(is_real, dest, my)
        recv, _, _, _, ovf_x = exchange(
            dest, [kl, jnp.where(is_real, v, 0),
                   jnp.where(is_real, occ, 0)],
            [_ONES, jnp.uint32(0), jnp.uint32(0)], n_dev, capacity)
        rk, rv, ro = recv
        sg, sv, so = jax.lax.sort([rk, rv, ro], num_keys=2,
                                  is_stable=False)
        # cross-source copies of a pair collapse; occurrences sum
        mm = sg.shape[0]
        pos = jnp.arange(mm, dtype=jnp.uint32)
        sent = sg == _ONES
        key_new = ((pos == 0) | (sg != _shift_right_one(sg, 0))) & ~sent
        pair_new = (key_new | (sv != _shift_right_one(sv, 0))) & ~sent
        key_end = ~sent & jnp.concatenate(
            [(key_new | sent)[1:], jnp.ones((1,), bool)])
        num_groups = jnp.sum(key_end.astype(jnp.uint32), dtype=jnp.uint32)
        cum_nd = cumsum_u32(pair_new.astype(jnp.uint32))
        cum_occ = cumsum_u32(so)
        pos1 = pos + 1
        packed = jnp.where(key_end, pos1, pos1 | jnp.uint32(1 << 31))
        res = jax.lax.sort([packed, sg, cum_nd, cum_occ], num_keys=1,
                           is_stable=False)
        gkey = res[1]
        gcd = res[2] - _shift_right_one(res[2], 0)
        gcnt = res[3] - _shift_right_one(res[3], 0)
        gvalid = pos < num_groups
        want_cnt = (jnp.uint32(n // n_groups)
                    + (gkey < jnp.uint32(n % n_groups)).astype(jnp.uint32))
        want_cd = jnp.minimum(want_cnt, jnp.uint32(n_values))
        cd_ok = jnp.all(jnp.where(gvalid, gcd == want_cd, True))
        cnt_ok = jnp.all(jnp.where(gvalid, gcnt == want_cnt, True))
        keys_ok = jnp.all(jnp.where(gvalid[1:], gkey[1:] > gkey[:-1],
                                    True))
        g_total = jax.lax.psum(num_groups, AXIS)
        outs = (cd_ok.reshape(1), cnt_ok.reshape(1), keys_ok.reshape(1),
                num_groups.reshape(1), g_total.reshape(1),
                ovf_x.reshape(1))
        if collect:
            outs = outs + (jnp.where(gvalid, gkey, _ONES),
                           jnp.where(gvalid, gcd, 0),
                           jnp.where(gvalid, gcnt, 0))
        return outs

    spec = P(AXIS)
    out_specs = [spec] * 6 + ([spec] * 3 if collect else [])
    fn = shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                   out_specs=tuple(out_specs), check_vma=False)
    return jax.jit(fn)


@dataclasses.dataclass
class DistBigDistinctResult:
    n: int
    n_groups: int
    n_values: int
    n_dev: int
    n_runs: int                  # per device
    num_groups: int
    groups_ok: bool
    cd_ok: bool
    cnt_ok: bool
    keys_ok: bool
    overflow: bool
    seconds: float
    dedup_s: float
    combine_s: float
    route_s: float
    rows_per_s: float
    table: dict | None = None

    @property
    def all_ok(self) -> bool:
        return (self.groups_ok and self.cd_ok and self.cnt_ok
                and self.keys_ok and not self.overflow
                and self.num_groups == min(self.n_groups, self.n))


def count_distinct_big_distributed(n: int, mesh: Mesh,
                                   n_groups: int = 1 << 16,
                                   n_values: int = 1 << 8,
                                   run_size: int = 1 << 26,
                                   samples_per_dev: int = 128,
                                   capacity_factor: float = 2.0,
                                   collect: bool = False,
                                   verbose: bool = False,
                                   force_composed: bool = False
                                   ) -> DistBigDistinctResult:
    """COUNT(DISTINCT value) GROUP BY key over n rows sharded as
    out-of-core runs across the mesh (see module docstring)."""
    n_dev = int(mesh.shape[AXIS])
    if n_dev == 1 and not force_composed:
        r = count_distinct_big(n, n_groups=n_groups, n_values=n_values,
                               run_size=run_size, collect=collect,
                               verbose=verbose)
        return DistBigDistinctResult(
            n=n, n_groups=n_groups, n_values=n_values, n_dev=1,
            n_runs=r.n_runs, num_groups=r.num_groups,
            groups_ok=r.groups_ok, cd_ok=r.cd_ok, cnt_ok=r.cnt_ok,
            keys_ok=r.keys_ok, overflow=r.overflow, seconds=r.seconds,
            dedup_s=r.dedup_s, combine_s=0.0, route_s=r.combine_s,
            rows_per_s=r.rows_per_s, table=r.table)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 32) and n_groups < (1 << 32) - 1
    n_local = n // n_dev
    n_runs = n_local // run_size
    pairs_bound = n_groups * n_values

    def cap128(x, hard):
        return min(-(-min(x, hard) // 128) * 128, hard)

    partial_cap = cap128(pairs_bound, run_size)
    local_cap = cap128(pairs_bound, n_local)
    capacity = max(int(np.ceil(capacity_factor * local_cap / n_dev)), 16)

    rep = NamedSharding(mesh, P(None))

    def _rep(x):
        return jax.device_put(jnp.asarray([x], jnp.uint32), rep)

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])
    runner = _runner_fn(mesh, n_local, run_size, n_groups, n_values,
                        partial_cap)
    run_exec = runner.lower(_rep(0)).compile()
    combiner = _local_combine_fn(mesh, n_runs, local_cap)
    ex_parts = tuple(jax.ShapeDtypeStruct((n_dev * partial_cap,),
                                          jnp.uint32)
                     for _ in range(3 * n_runs))
    comb_exec = combiner.lower(*ex_parts).compile()
    router = _route_count_fn(mesh, n_dev, samples_per_dev, capacity,
                             n, n_groups, n_values, collect)
    exl = jax.ShapeDtypeStruct((n_dev * local_cap,), jnp.uint32)
    exm = jax.ShapeDtypeStruct((n_dev,), jnp.uint32)
    route_exec = router.lower(exl, exl, exl, exm).compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    parts, m_runs = [], []
    for rr in range(n_runs):
        klo, v, occ, m = run_exec(_rep(rr))
        parts += [klo, v, occ]
        m_runs.append(m)
    m_run_host = np.concatenate([np.asarray(m) for m in m_runs])
    ovf_run = bool((m_run_host > partial_cap).any())
    t1 = time.perf_counter()
    dk, dv, do, m_loc, ovf_loc = comb_exec(*parts)
    m_loc_host = np.asarray(m_loc)
    ovf_l = bool(np.asarray(ovf_loc).any())
    t2 = time.perf_counter()
    out = route_exec(dk, dv, do, m_loc)
    cd_ok, cnt_ok, keys_ok, ngs, g_total, ovf_x = \
        (np.asarray(x) for x in out[:6])
    t3 = time.perf_counter()
    if verbose:
        print(f"dbigdistinct: D={n_dev} R={n_runs} caps "
              f"{partial_cap}/{local_cap}/{capacity}; pairs/run max "
              f"{m_run_host.max()}, per-dev {m_loc_host.max()}; "
              f"A={t1 - t0:.2f}s L={t2 - t1:.2f}s R={t3 - t2:.2f}s")
    table = None
    if collect:
        gk = np.asarray(out[6]).reshape(n_dev, -1)
        gcd = np.asarray(out[7]).reshape(n_dev, -1)
        gcnt = np.asarray(out[8]).reshape(n_dev, -1)
        ks, cds, cns = [], [], []
        for d in range(n_dev):
            c = int(ngs[d])
            ks.append(gk[d, :c])
            cds.append(gcd[d, :c])
            cns.append(gcnt[d, :c])
        table = {"key": np.concatenate(ks),
                 "count_distinct": np.concatenate(cds),
                 "count": np.concatenate(cns)}
    secs = t3 - t0
    return DistBigDistinctResult(
        n=n, n_groups=n_groups, n_values=n_values, n_dev=n_dev,
        n_runs=n_runs, num_groups=int(g_total.max()),
        groups_ok=bool(g_total.max() == min(n_groups, n)),
        cd_ok=bool(cd_ok.all()), cnt_ok=bool(cnt_ok.all()),
        keys_ok=bool(keys_ok.all()),
        overflow=ovf_run or ovf_l or bool(ovf_x.any()),
        seconds=secs, dedup_s=t1 - t0, combine_s=t2 - t1,
        route_s=t3 - t2, rows_per_s=n / secs, table=table)
