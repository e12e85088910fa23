"""Distributed x out-of-core set operations: UNION / INTERSECT / EXCEPT.

Completes the set-algebra composition row. Dedup is the compression at
EVERY level (the invariant shared with ops/dbigdistinct.py — here the
"value" plane of the pair machinery is the SIDE flag):

  phase A   per device, per run, per side: generate + dedup the run's
            keys on device (sorted distinct keys + exact occurrence
            counts, bounded by min(run_size, g_side));
  phase L   per device: ONE resident merge of its partial tables from
            BOTH sides into a distinct (key, side) pair table —
            cross-run duplicates collapse in the pair sort, occurrence
            counts survive by summation (bounded by g_a + g_b);
  phase R   route the deduped pairs by KEY splitters (every key's
            verdict becomes local and exact) with an explicit validity
            plane, one two-tier exchange; per device: per-key side
            multiplicities from two cumsum differences (cross-source
            copies of a pair just add up in the cumsums — no second
            dedup needed, the algebra of distributed_set_op), the op
            predicate, compaction of qualifying keys with per-side
            multiplicities, closed-form per-key verification, and a
            psum of qualifying counts.

Exchange volume = locally distinct (key, side) pairs, never rows; every
cap overflow (per-run, per-device, exchange) is DETECTED exactly.
Splitter ranges are disjoint and ascending across devices, so the
concatenated per-device results ARE the global DISTINCT result.

Data model: as ops/bigsetops.py (side A keys = idx mod g_a, side B
keys = idx mod g_b + offset); sharding rows by contiguous index blocks
leaves the global multiset unchanged, so the same closed forms verify.

Reference contrast: single device, one queue submit
(/root/reference/src/main.rs:727); SURVEY §2c mandates the scaled
composition — applied to set algebra.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_qe.exchange.shuffle import (AXIS, exchange, route_by_splitters,
                                     sample_splitters)
from tpu_qe.ops.aggregate import _shift_right_one
from tpu_qe.ops.bigsetops import (expected_result_numpy, keys_of_index,
                                  set_op_big)
from tpu_qe.ops.dbigdistinct import _dedup_sorted
from tpu_qe.ops.segscan import cumsum_u32
from tpu_qe.ops.setops import _OPS, _qualifies

_ONES = jnp.uint32(0xFFFFFFFF)


def _runner_fn(mesh: Mesh, n_local: int, run_size: int, n_groups: int,
               offset: int, partial_cap: int):
    """Phase A: one side's run rr on every device — generate, sort,
    dedup distinct keys + exact occurrence counts, compact."""

    def body(rr):
        d = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        base = d * jnp.uint32(n_local) + rr[0] * jnp.uint32(run_size)
        idx = base + jnp.arange(run_size, dtype=jnp.uint32)
        k = keys_of_index(idx, n_groups, offset)
        sk = jax.lax.sort([k], num_keys=1, is_stable=False)[0]
        zero = jnp.zeros_like(sk)
        klo, _, occ, m = _dedup_sorted(sk, zero)
        cut = lambda a: jax.lax.slice(a, (0,), (partial_cap,))  # noqa: E731
        return cut(klo), cut(occ), m.reshape(1)

    fn = shard_map(body, mesh=mesh, in_specs=(P(None),),
                   out_specs=(P(AXIS), P(AXIS), P(AXIS)),
                   check_vma=False)
    return jax.jit(fn)


def _local_combine_fn(mesh: Mesh, n_parts: int, local_cap: int):
    """Phase L: merge a device's per-run tables of BOTH sides into ONE
    deduped (key, side) pair table (occurrences sum across runs)."""

    def body(*cols):
        klo = jnp.concatenate(cols[0::3])
        side = jnp.concatenate(cols[1::3])
        occ = jnp.concatenate(cols[2::3])
        sk, ss, so = jax.lax.sort([klo, side, occ], num_keys=2,
                                  is_stable=False)
        dk, dsd, do, m = _dedup_sorted(sk, ss, occ_in=so)
        cut = lambda a: jax.lax.slice(a, (0,), (local_cap,))  # noqa: E731
        ovf = (m > jnp.uint32(local_cap)).astype(jnp.uint32)
        return cut(dk), cut(dsd), cut(do), m.reshape(1), ovf.reshape(1)

    specs = tuple([P(AXIS)] * (3 * n_parts))
    fn = shard_map(body, mesh=mesh, in_specs=specs,
                   out_specs=tuple([P(AXIS)] * 5), check_vma=False)
    return jax.jit(fn)


def _route_qualify_fn(mesh: Mesh, op: str, n_dev: int,
                      samples_per_dev: int, capacity: int, n_a: int,
                      g_a: int, n_b: int, g_b: int, offset: int,
                      collect: bool):
    """Phase R: splitter-route pairs by key, derive per-key (count_a,
    count_b) locally, qualify, verify the closed form, psum counts."""

    def body(klo, side, occ, m_arr):
        m_loc = m_arr[0]
        is_real = jnp.arange(klo.shape[0], dtype=jnp.uint32) < m_loc
        kl = jnp.where(is_real, klo, _ONES)
        kh = jnp.where(is_real, jnp.uint32(0), _ONES)
        sp_lo, sp_hi = sample_splitters(kl, kh, n_dev, samples_per_dev,
                                        n_valid=m_loc)
        my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        dest = route_by_splitters(kl, kh, sp_lo, sp_hi)
        dest = jnp.where(is_real, dest, my)
        recv, _, _, _, ovf_x = exchange(
            dest, [kl, jnp.where(is_real, side, 0),
                   jnp.where(is_real, occ, 0)],
            [_ONES, jnp.uint32(0), jnp.uint32(0)], n_dev, capacity)
        rk, rs, ro = recv
        sk, ss, so = jax.lax.sort([rk, rs, ro], num_keys=1,
                                  is_stable=False)
        mm = sk.shape[0]
        pos = jnp.arange(mm, dtype=jnp.uint32)
        sent = sk == _ONES
        key_new = ((pos == 0) | (sk != _shift_right_one(sk, 0))) & ~sent
        key_end = ~sent & jnp.concatenate(
            [(key_new | sent)[1:], jnp.ones((1,), bool)])
        n_keys = jnp.sum(key_end.astype(jnp.uint32), dtype=jnp.uint32)
        cum_b = cumsum_u32(so * ss)
        cum_tot = cumsum_u32(so)
        pos1 = pos + 1
        packed = jnp.where(key_end, pos1, pos1 | jnp.uint32(1 << 31))
        res = jax.lax.sort([packed, sk, cum_b, cum_tot], num_keys=1,
                           is_stable=False)
        gkey = res[1]
        cb = res[2] - _shift_right_one(res[2], 0)
        ca = (res[3] - _shift_right_one(res[3], 0)) - cb
        gvalid = pos < n_keys
        want_ca = jnp.where(
            gkey < jnp.uint32(g_a),
            jnp.uint32(n_a // g_a)
            + (gkey < jnp.uint32(n_a % g_a)).astype(jnp.uint32),
            jnp.uint32(0))
        kb = gkey - jnp.uint32(offset)
        in_b = (gkey >= jnp.uint32(offset)) & (kb < jnp.uint32(g_b))
        want_cb = jnp.where(
            in_b,
            jnp.uint32(n_b // g_b)
            + (kb < jnp.uint32(n_b % g_b)).astype(jnp.uint32),
            jnp.uint32(0))
        counts_ok = jnp.all(jnp.where(
            gvalid, (ca == want_ca) & (cb == want_cb), True))
        keys_ok = jnp.all(jnp.where(gvalid[1:], gkey[1:] > gkey[:-1],
                                    True))
        keep = gvalid & _qualifies(op, ca > 0, cb > 0)
        num = jnp.sum(keep.astype(jnp.uint32), dtype=jnp.uint32)
        num_tot = jax.lax.psum(num, AXIS)
        outs = (counts_ok.reshape(1), keys_ok.reshape(1),
                num.reshape(1), num_tot.reshape(1), ovf_x.reshape(1))
        if collect:
            packed2 = jnp.where(keep, pos, pos | jnp.uint32(1 << 31))
            res2 = jax.lax.sort([packed2, gkey, ca, cb], num_keys=1,
                                is_stable=False)
            rvalid = pos < num
            outs = outs + (jnp.where(rvalid, res2[1], _ONES),
                           jnp.where(rvalid, res2[2], 0),
                           jnp.where(rvalid, res2[3], 0))
        return outs

    spec = P(AXIS)
    out_specs = [spec] * 5 + ([spec] * 3 if collect else [])
    fn = shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                   out_specs=tuple(out_specs), check_vma=False)
    return jax.jit(fn)


@dataclasses.dataclass
class DistBigSetOpResult:
    op: str
    n_a: int
    n_b: int
    g_a: int
    g_b: int
    offset: int
    n_dev: int
    n_runs_a: int                # per device
    n_runs_b: int
    num: int
    expected_num: int
    counts_ok: bool
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
        return (self.counts_ok and self.keys_ok and not self.overflow
                and self.num == self.expected_num)


def set_op_big_distributed(op: str, n_a: int, n_b: int, mesh: Mesh,
                           g_a: int = 1 << 16, g_b: int = 1 << 16,
                           offset: int = 1 << 15,
                           run_size: int = 1 << 26,
                           samples_per_dev: int = 128,
                           capacity_factor: float = 2.0,
                           collect: bool = False, verbose: bool = False,
                           force_composed: bool = False
                           ) -> DistBigSetOpResult:
    """DISTINCT-semantics set operation over two key bags sharded as
    out-of-core runs across the mesh (see module docstring)."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    n_dev = int(mesh.shape[AXIS])
    if n_dev == 1 and not force_composed:
        r = set_op_big(op, n_a, n_b, g_a=g_a, g_b=g_b, offset=offset,
                       run_size=run_size, collect=collect,
                       verbose=verbose)
        return DistBigSetOpResult(
            op=op, n_a=n_a, n_b=n_b, g_a=g_a, g_b=g_b, offset=offset,
            n_dev=1, n_runs_a=r.n_runs_a, n_runs_b=r.n_runs_b,
            num=r.num, expected_num=r.expected_num,
            counts_ok=r.counts_ok, keys_ok=r.keys_ok,
            overflow=r.overflow, seconds=r.seconds, dedup_s=r.dedup_s,
            combine_s=0.0, route_s=r.combine_s,
            rows_per_s=r.rows_per_s, table=r.table)
    for n, nm in ((n_a, "n_a"), (n_b, "n_b")):
        assert n % (n_dev * run_size) == 0, \
            (f"{nm} must be a multiple of devices*run_size "
             f"({nm}={n}, devices={n_dev}, run_size={run_size})")
    assert n_a + n_b < (1 << 32)
    assert max(g_a, offset + g_b) < (1 << 32) - 1
    nla, nlb = n_a // n_dev, n_b // n_dev
    runs_a, runs_b = nla // run_size, nlb // run_size

    def cap128(x, hard):
        return min(-(-min(x, hard) // 128) * 128, hard)

    cap_a = cap128(g_a, run_size)
    cap_b = cap128(g_b, run_size)
    local_cap = cap128(g_a + g_b, nla + nlb)
    capacity = max(int(np.ceil(capacity_factor * local_cap / n_dev)), 16)

    rep = NamedSharding(mesh, P(None))

    def _rep(x):
        return jax.device_put(jnp.asarray([x], jnp.uint32), rep)

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])
    runners = {
        0: _runner_fn(mesh, nla, run_size, g_a, 0, cap_a),
        1: _runner_fn(mesh, nlb, run_size, g_b, offset, cap_b)}
    run_execs = {s: r.lower(_rep(0)).compile()
                 for s, r in runners.items()}
    n_parts = runs_a + runs_b
    combiner = _local_combine_fn(mesh, n_parts, local_cap)
    ex_parts = []
    for cap, runs in ((cap_a, runs_a), (cap_b, runs_b)):
        ex_parts += [jax.ShapeDtypeStruct((n_dev * cap,), jnp.uint32)
                     ] * (3 * runs)
    comb_exec = combiner.lower(*ex_parts).compile()
    router = _route_qualify_fn(mesh, op, n_dev, samples_per_dev,
                               capacity, n_a, g_a, n_b, g_b, offset,
                               collect)
    exl = jax.ShapeDtypeStruct((n_dev * local_cap,), jnp.uint32)
    exm = jax.ShapeDtypeStruct((n_dev,), jnp.uint32)
    route_exec = router.lower(exl, exl, exl, exm).compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    parts, m_runs, caps_of = [], [], []
    for s, runs, cap in ((0, runs_a, cap_a), (1, runs_b, cap_b)):
        side_plane = jax.device_put(
            jnp.full((n_dev * cap,), s, jnp.uint32),
            NamedSharding(mesh, P(AXIS)))
        for rr in range(runs):
            klo, occ, m = run_execs[s](_rep(rr))
            parts += [klo, side_plane, occ]
            m_runs.append(m)
            caps_of.append(cap)
    m_run_host = np.stack([np.asarray(m) for m in m_runs])
    ovf_run = bool((m_run_host.max(axis=1)
                    > np.array(caps_of)).any())        # fence A
    t1 = time.perf_counter()
    dk, dsd, do, m_loc, ovf_loc = comb_exec(*parts)
    ovf_l = bool(np.asarray(ovf_loc).any())
    t2 = time.perf_counter()
    out = route_exec(dk, dsd, do, m_loc)
    counts_ok, keys_ok, nums, num_tot, ovf_x = \
        (np.asarray(x) for x in out[:5])
    t3 = time.perf_counter()
    ek, _, _ = expected_result_numpy(op, n_a, g_a, n_b, g_b, offset)
    if verbose:
        print(f"dbigsetops[{op}]: D={n_dev} R={runs_a}+{runs_b} caps "
              f"{cap_a}/{cap_b}/{local_cap}/{capacity}; compile "
              f"{compile_s:.1f}s A={t1 - t0:.2f}s L={t2 - t1:.2f}s "
              f"R={t3 - t2:.2f}s")
    table = None
    if collect:
        gk = np.asarray(out[5]).reshape(n_dev, -1)
        ca_p = np.asarray(out[6]).reshape(n_dev, -1)
        cb_p = np.asarray(out[7]).reshape(n_dev, -1)
        ks, cas, cbs = [], [], []
        for d in range(n_dev):
            c = int(nums[d])
            ks.append(gk[d, :c])
            cas.append(ca_p[d, :c])
            cbs.append(cb_p[d, :c])
        table = {"key": np.concatenate(ks),
                 "count_a": np.concatenate(cas),
                 "count_b": np.concatenate(cbs)}
    secs = t3 - t0
    return DistBigSetOpResult(
        op=op, n_a=n_a, n_b=n_b, g_a=g_a, g_b=g_b, offset=offset,
        n_dev=n_dev, n_runs_a=runs_a, n_runs_b=runs_b,
        num=int(num_tot.max()), expected_num=len(ek),
        counts_ok=bool(counts_ok.all()), keys_ok=bool(keys_ok.all()),
        overflow=ovf_run or ovf_l or bool(ovf_x.any()), seconds=secs,
        dedup_s=t1 - t0, combine_s=t2 - t1, route_s=t3 - t2,
        rows_per_s=(n_a + n_b) / secs, table=table)
