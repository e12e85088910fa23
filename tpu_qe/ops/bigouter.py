"""Out-of-core LEFT/FULL OUTER join: combined sides larger than one program.

ops/join.py::join_outer covers the in-core tiers and join_outer_padded
the distributed shards (all copies of a key co-located make each shard's
outer verdict exact). This module lifts the outer family past one
program's HBM with the bigjoin bucket recipe (ops/bigjoin.py): key-space
buckets cut BOTH sorted sides by the same splitters, so every copy of a
key — left and right — lands in exactly one bucket, and each bucket's
LEFT verdict (matched / NULL-right) and RIGHT verdict (right-only) are
both local and globally exact. Phase C runs join_outer_padded per bucket
with validity masks; the NULL convention (matched=False + zeroed right
columns, exact counts, never silent truncation) carries through
unchanged.

Benchmark data model (device-generated — no host streaming,
sort/bigsort.py): right keys are INJECTIVE closed forms
of the right index (lo = i<<1, hi = fmix(i) — lo even, all keys
distinct), so every outer verdict is decidable per row on device:

  right row i:  key  = (lo = i<<1, hi = fmix32(i ^ seed))
  left  row j:  even j -> the key of right row 2*((j>>1) mod (n_r/2))
                (a guaranteed match on an EVEN right index);
                odd  j -> a low-bit-SET key (a guaranteed miss — every
                right lo is even)
  joined value  rv = fmix32(key.lo ^ key.hi ^ C)  (a closed form of the
                key, recomputed per bucket, never stored)

With (n_l+1)//2 >= n_r//2 (asserted) every even right index is hit, so
the expected verdicts are closed forms: left row j matched iff j even
(total (n_l+1)//2); right row i right-only iff i odd (total n_r//2);
every left row claims exactly ONE output slot (right keys unique), so
the left-expanded section is exactly the bucket's left rows and overflow
is impossible by construction. Per-bucket device checks verify all of
it: match flags vs lidx parity, joined values vs f(key), zeroed right
columns on unmatched slots, right-only rows vs ridx parity + key
closed form, exact section counts.

Reference contrast: the reference has no joins at all
(/root/reference/src/main.rs is a sort test); this completes the outer
half of SURVEY.md §7's query-operator mandate at out-of-core scale.
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
from tpu_qe.hashing import murmur_fmix32, murmur_fmix32_numpy
from tpu_qe.ops.bigjoin import _plan_buckets
from tpu_qe.ops.join import join_outer_padded
from tpu_qe.table import Table
from tpu_qe.utils.checkpoint import RunState as _RunState

_ONES = jnp.uint32(0xFFFFFFFF)
_VAL_C = jnp.uint32(0x07E12B5)  # outer-join value salt


def _rkey_of_index(i: jnp.ndarray, seed: int) -> U64:
    """Injective right key: lo = i<<1 (even, distinct), hi = fmix(i)."""
    return U64(i << jnp.uint32(1), murmur_fmix32(i ^ jnp.uint32(seed)))


def _rval_of_key(key: U64) -> jnp.ndarray:
    return murmur_fmix32(key.lo ^ key.hi ^ _VAL_C)


def _lkey_of_index(j: jnp.ndarray, n_r: int, seed: int) -> U64:
    """Even j -> the key of right row 2*((j>>1) mod (n_r/2)); odd j -> a
    low-bit-SET miss key (right lo is always even)."""
    i = (j >> jnp.uint32(1)) % jnp.uint32(n_r >> 1) << jnp.uint32(1)
    hit = _rkey_of_index(i, seed)
    even = (j & jnp.uint32(1)) == 0
    miss_lo = murmur_fmix32(j ^ jnp.uint32(seed + 0x5A17)) | jnp.uint32(1)
    miss_hi = murmur_fmix32(j ^ jnp.uint32(seed + 0xB055))
    return U64(jnp.where(even, hit.lo, miss_lo),
               jnp.where(even, hit.hi, miss_hi))


def rkeys_numpy(n_r: int, seed: int = 7) -> np.ndarray:
    """Host twin of the right-key generator (oracle tests)."""
    i = np.arange(n_r, dtype=np.uint32)
    lo = (i << np.uint32(1)).astype(np.uint64)
    hi = murmur_fmix32_numpy(i ^ np.uint32(seed)).astype(np.uint64)
    return lo | (hi << np.uint64(32))


def lkeys_numpy(n_l: int, n_r: int, seed: int = 7) -> np.ndarray:
    """Host twin of the left-key generator (oracle tests)."""
    j = np.arange(n_l, dtype=np.uint32)
    i = ((j >> np.uint32(1)) % np.uint32(n_r >> 1)) << np.uint32(1)
    hit_lo = (i << np.uint32(1)).astype(np.uint64)
    hit_hi = murmur_fmix32_numpy(i ^ np.uint32(seed)).astype(np.uint64)
    hit = hit_lo | (hit_hi << np.uint64(32))
    m_lo = (murmur_fmix32_numpy(j ^ np.uint32(seed + 0x5A17))
            | np.uint32(1)).astype(np.uint64)
    m_hi = murmur_fmix32_numpy(j ^ np.uint32(seed + 0xB055)).astype(
        np.uint64)
    miss = m_lo | (m_hi << np.uint64(32))
    return np.where(j % 2 == 0, hit, miss)


def rval_numpy(key: np.ndarray) -> np.ndarray:
    lo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (key >> np.uint64(32)).astype(np.uint32)
    return murmur_fmix32_numpy(lo ^ hi ^ np.uint32(int(_VAL_C)))


@functools.partial(jax.jit, static_argnames=("n", "n_r", "seed", "side"))
def _make_sorted_side(n: int, n_r: int, seed: int, side: str):
    """Generate + key-sort one side; both carry their index payload
    (left for output identity, right for the right-only closed form)."""
    idx = jnp.arange(n, dtype=jnp.uint32)
    key = (_rkey_of_index(idx, seed) if side == "right"
           else _lkey_of_index(idx, n_r, seed))
    hi, lo, pay = jax.lax.sort([key.hi, key.lo, idx], num_keys=3,
                               is_stable=False)
    return lo, hi, pay


def _outer_bucket_fn(cap_l: int, cap_r: int, full: bool, seed: int,
                     collect: bool = False):
    """Phase-C body: slice one key-range bucket from each sorted side,
    join_outer_padded with validity masks, verify every verdict against
    the generator's closed forms on device."""

    @jax.jit
    def run(st_l, dl_l, sz_l, st_r, dl_r, sz_r,
            llo, lhi, lidx, rlo, rhi, ridx):
        ar_l = jnp.arange(cap_l, dtype=jnp.uint32)
        ar_r = jnp.arange(cap_r, dtype=jnp.uint32)

        def seg(col, start, cap, delta, size, ar, fill):
            s = jax.lax.dynamic_slice(col, (start,), (cap,))
            d = delta.astype(jnp.uint32)
            return jnp.where((ar >= d) & (ar < d + size.astype(jnp.uint32)),
                             s, fill)

        s_llo = seg(llo, st_l, cap_l, dl_l, sz_l, ar_l, _ONES)
        s_lhi = seg(lhi, st_l, cap_l, dl_l, sz_l, ar_l, _ONES)
        s_lidx = seg(lidx, st_l, cap_l, dl_l, sz_l, ar_l, jnp.uint32(0))
        l_valid = (ar_l >= dl_l.astype(jnp.uint32)) & (
            ar_l < dl_l.astype(jnp.uint32) + sz_l.astype(jnp.uint32))
        s_rlo = seg(rlo, st_r, cap_r, dl_r, sz_r, ar_r, _ONES)
        s_rhi = seg(rhi, st_r, cap_r, dl_r, sz_r, ar_r, _ONES)
        s_ridx = seg(ridx, st_r, cap_r, dl_r, sz_r, ar_r, jnp.uint32(0))
        r_valid = (ar_r >= dl_r.astype(jnp.uint32)) & (
            ar_r < dl_r.astype(jnp.uint32) + sz_r.astype(jnp.uint32))

        rkey = U64(s_rlo, s_rhi)
        rv = jnp.where(r_valid, _rval_of_key(rkey), jnp.uint32(0))
        lkey = U64(s_llo, s_lhi)
        # the left key rides through as ordinary left columns — output
        # slots are the COMPACTED valid left rows (pads claim no slot),
        # so the raw segment planes do NOT align with slots when the
        # dynamic-slice start was host-clamped (delta > 0)
        res = join_outer_padded(
            Table({"lidx": s_lidx, "klo": s_llo, "khi": s_lhi}),
            Table({"ridx": s_ridx, "rv": rv}),
            lkey, rkey, l_valid, r_valid, out_budget=cap_l, full=full)

        out, matched = res.table, res.matched
        slot_valid = jnp.arange(cap_l, dtype=jnp.uint32) < res.num_out
        # every valid slot's verdict is the lidx-parity closed form;
        # matched slots carry rv == f(key); unmatched slots carry the
        # NULL convention (zeroed right columns)
        expect = (out["lidx"] & jnp.uint32(1)) == 0
        want_rv = _rval_of_key(U64(out["klo"], out["khi"]))
        m_ok = jnp.all(~slot_valid | (matched == expect))
        v_ok = jnp.all(
            jnp.where(matched, out["rv"] == want_rv,
                      (out["rv"] == 0) & (out["ridx"] == 0)))
        n_matched = jnp.sum((matched & slot_valid).astype(jnp.uint32))
        n_even = jnp.sum(
            (l_valid & ((s_lidx & jnp.uint32(1)) == 0)).astype(jnp.uint32))
        scalars = (m_ok.astype(jnp.uint32), v_ok.astype(jnp.uint32),
                   res.overflow, res.num_out, n_matched, n_even,
                   jnp.sum(sz_l.astype(jnp.uint32)),
                   jnp.sum(sz_r.astype(jnp.uint32)))
        if full:
            ro, n_ro = res.right_only, res.num_right_only
            ro_valid = jnp.arange(cap_r, dtype=jnp.uint32) < n_ro
            gk = _rkey_of_index(ro["ridx"], seed)
            ro_ok = jnp.all(~ro_valid | (
                ((ro["ridx"] & jnp.uint32(1)) == 1)
                & (ro["_key"].lo == gk.lo) & (ro["_key"].hi == gk.hi)
                & (ro["rv"] == _rval_of_key(ro["_key"]))))
            n_odd = jnp.sum(
                (r_valid & ((s_ridx & jnp.uint32(1)) == 1)).astype(
                    jnp.uint32))
            scalars = scalars + (ro_ok.astype(jnp.uint32), n_ro, n_odd)
        else:
            u0 = jnp.uint32(0)
            scalars = scalars + (jnp.uint32(1), u0, u0)
        if not collect:
            return scalars
        stream = (out["klo"], out["khi"], out["lidx"],
                  (matched & slot_valid).astype(jnp.uint32),
                  out["rv"], slot_valid.astype(jnp.uint32))
        if full:
            stream = stream + (res.right_only["ridx"],
                               (jnp.arange(cap_r, dtype=jnp.uint32)
                                < res.num_right_only).astype(jnp.uint32))
        return scalars + stream

    return run


@dataclasses.dataclass(frozen=True)
class BigOuterResult:
    n_l: int
    n_r: int
    full: bool
    seconds: float
    rows_per_s: float          # left rows per second through the join
    matched: int               # exact matched left rows
    num_out: int               # exact left-expanded output rows
    right_only: int            # exact right-only rows (FULL)
    match_ok: bool
    val_ok: bool
    ro_ok: bool
    count_ok: bool
    phase_a_s: float
    phase_c_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return (self.match_ok and self.val_ok and self.ro_ok
                and self.count_ok)


class _OuterState(_RunState):
    """Checkpoint state: bucket plan (both sides) + 11 scalars/bucket.
    The sorted sides regenerate deterministically (bigsort reasoning)."""

    N_SCALARS = 11

    @staticmethod
    def _path(directory: str) -> str:
        return os.path.join(directory, "bigouter_state.npz")


def join_big_outer(n_l: int, n_r: int, how: str = "full",
                   n_buckets: int | None = None, seed: int = 7,
                   samples_per_side: int = 8192, verbose: bool = False,
                   collect: bool = False,
                   checkpoint_dir: str | None = None):
    """Out-of-core LEFT/FULL OUTER join of n_l x n_r generated rows.

    Same bucket recipe as join_big (ops/bigjoin.py) with
    join_outer_padded as the per-bucket joiner; every bucket's left AND
    right verdicts verified on device against the construction's closed
    forms (module docstring). how="left" skips the right-only probe.
    collect=True assembles the valid left-expanded slots (and, FULL, the
    right-only rows) on the host for oracle tests. checkpoint_dir: same
    resume contract as join_big.
    """
    assert how in ("left", "full"), how
    assert n_l < (1 << 32) and n_r < (1 << 31)  # lo = i<<1 injective
    # n_r >= 2: _lkey_of_index takes j % (n_r >> 1) — n_r == 0 would pass
    # the parity/coverage guards and silently divide by zero under jit
    assert n_r >= 2 and n_r % 2 == 0, \
        "data model splits right rows by index parity (n_r >= 2, even)"
    assert (n_l + 1) // 2 >= n_r // 2, \
        "coverage: every even right index must be hit"
    full = how == "full"
    if n_buckets is None:
        n_buckets = max(2, int(np.ceil((n_l + n_r) / (1 << 26))))
    meta = np.asarray([n_l, n_r, int(full), n_buckets, seed,
                       samples_per_side, 0x0073], np.int64)
    state = (_OuterState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    left_exec = _make_sorted_side.lower(n=n_l, n_r=n_r, seed=seed,
                                        side="left").compile()
    right_exec = _make_sorted_side.lower(n=n_r, n_r=n_r, seed=seed,
                                         side="right").compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    llo, lhi, lidx = left_exec()
    rlo, rhi, ridx = right_exec()
    np.asarray(llo[-1:]), np.asarray(rlo[-1:])  # fence
    t_a = time.perf_counter() - t0

    if state is not None:
        bl, br = state.bounds[0], state.bounds[1]
        t_b = 0.0
    else:
        tcp = time.perf_counter()
        plan_exec = _plan_buckets.lower(
            llo, lhi, rlo, rhi, n_buckets=n_buckets,
            per_side=samples_per_side).compile()
        compile_s += time.perf_counter() - tcp
        t_b0 = time.perf_counter()
        bl, br = plan_exec(llo, lhi, rlo, rhi)
        bl = np.asarray(bl).astype(np.int64)
        br = np.asarray(br).astype(np.int64)
        t_b = time.perf_counter() - t_b0
        if checkpoint_dir is not None:
            state = _OuterState.fresh(checkpoint_dir, meta,
                                      np.stack([bl, br]), n_buckets)

    def seg_plan(bounds, n):
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [n]])
        return starts, (ends - starts)

    st_l, sz_l = seg_plan(bl, n_l)
    st_r, sz_r = seg_plan(br, n_r)
    quantum = 1 << 20 if max(n_l, n_r) >= (1 << 24) else 256
    cap_l = min(-(-max(int(sz_l.max()), 1) // quantum) * quantum, n_l)
    cap_r = min(-(-max(int(sz_r.max()), 1) // quantum) * quantum, n_r)
    assert cap_l + cap_r < (1 << 30), (cap_l, cap_r)
    if verbose:
        print(f"bigouter[{how}]: {n_buckets} buckets, cap_l={cap_l} "
              f"(max {int(sz_l.max())}), cap_r={cap_r} "
              f"(max {int(sz_r.max())})")

    tcm = time.perf_counter()
    bucket = _outer_bucket_fn(cap_l, cap_r, full, seed, collect=collect)
    z = jnp.int32(0)
    bucket_exec = bucket.lower(z, z, z, z, z, z, llo, lhi, lidx,
                               rlo, rhi, ridx).compile()
    compile_s += time.perf_counter() - tcm

    t1 = time.perf_counter()
    skip = set()
    if state is not None and not collect:
        skip = {b for b in range(n_buckets) if state.done[b]}
        if verbose and skip:
            print(f"bigouter: resuming — {len(skip)}/{n_buckets} buckets "
                  "already joined")
    pending = {}
    host_vals = {}
    collected = []
    ceil_l, ceil_r = max(n_l - cap_l, 0), max(n_r - cap_r, 0)
    for b in range(n_buckets):
        if b in skip:
            continue
        cl = min(st_l[b], ceil_l)
        cr = min(st_r[b], ceil_r)
        out = bucket_exec(
            jnp.int32(cl), jnp.int32(st_l[b] - cl), jnp.int32(sz_l[b]),
            jnp.int32(cr), jnp.int32(st_r[b] - cr), jnp.int32(sz_r[b]),
            llo, lhi, lidx, rlo, rhi, ridx)
        if collect:
            # read back NOW and drop the device planes before the next
            # dispatch: each collect result holds cap_l + cap_r padded
            # output planes, so retaining all buckets until a final
            # readback loop scales peak HBM with n_buckets — the
            # all-buckets-held OOM trap (CLAUDE.md). collect is the
            # oracle-test path; losing dispatch pipelining costs nothing
            # that matters there.
            host_vals[b] = [int(np.asarray(x)) for x in out[:11]]
            s_llo, s_lhi, o_lidx, o_m, o_rv, o_v = [
                np.asarray(x) for x in out[11:17]]
            keep = o_v.astype(bool)
            k64 = (s_lhi.astype(np.uint64) << np.uint64(32)) \
                | s_llo.astype(np.uint64)
            ent = dict(key=k64[keep], lidx=o_lidx[keep],
                       matched=o_m[keep].astype(bool),
                       value=o_rv[keep])
            if full:
                ro_i, ro_v = np.asarray(out[17]), np.asarray(out[18])
                ent["ro_ridx"] = ro_i[ro_v.astype(bool)]
            collected.append(ent)
            del out
        else:
            pending[b] = out
    matched = num_out = n_ro = rows_l = rows_r = expected = 0
    m_ok = v_ok = ro_ok = True
    ovf = 0
    for b in range(n_buckets):
        if b in skip:
            vals = [int(v) for v in state.scalars[b]]
        else:
            vals = (host_vals[b] if collect else
                    [int(np.asarray(x)) for x in pending.pop(b)])
            if state is not None:
                state.record(b, vals)
        (mo, vo, ov, no, nm, ne, nl_b, nr_b, roo, nro, nodd) = vals
        m_ok &= bool(mo)
        v_ok &= bool(vo)
        ro_ok &= bool(roo) and (nro == nodd)
        ovf += ov
        num_out += no
        matched += nm
        expected += ne
        n_ro += nro
        rows_l += nl_b
        rows_r += nr_b
        if verbose:
            print(f"  bucket {b}: {nl_b}+{nr_b} rows, {nm} matched, "
                  f"{nro} right-only ok={bool(mo) and bool(vo)}")
    t_c = time.perf_counter() - t1

    count_ok = (ovf == 0 and rows_l == n_l and rows_r == n_r
                and num_out == n_l
                and matched == expected == (n_l + 1) // 2
                and (not full or n_ro == n_r - n_r // 2))
    dt = t_a + t_b + t_c
    res = BigOuterResult(
        n_l=n_l, n_r=n_r, full=full, seconds=dt, rows_per_s=n_l / dt,
        matched=matched, num_out=num_out, right_only=n_ro,
        match_ok=m_ok, val_ok=v_ok, ro_ok=ro_ok, count_ok=count_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if collect:
        out = {
            "key": np.concatenate([c["key"] for c in collected]),
            "lidx": np.concatenate([c["lidx"] for c in collected]),
            "matched": np.concatenate([c["matched"] for c in collected]),
            "value": np.concatenate([c["value"] for c in collected]),
        }
        if full:
            out["ro_ridx"] = np.concatenate(
                [c["ro_ridx"] for c in collected])
        return res, out
    return res
