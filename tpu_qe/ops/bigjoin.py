"""Out-of-core FK join: combined sides larger than one join program.

join_fk_scan sorts the COMBINED (right + left) stream with 3+P operands,
so it asserts n_l + n_r < 2^30 (ops/join.py) — a 512M x 512M join is out
of reach as one program even though each SIDE'S sort fits. This module
lifts the cap with the bigsort bucket-partition recipe:

  phase A   sort each side by key in its own resident program (two
            ~n*12-byte sorted arrays stay in HBM);
  phase B   splitters at the B-quantiles of the UNION of both key
            distributions; per-side bucket boundaries via searchsorted —
            EXACT demands, so the static per-bucket capacities carry no
            sampling error (plan-then-execute);
  phase C   per bucket: dynamic-slice one segment from each side
            (host-pre-clamped starts + delta masks), run join_fk_scan on
            the <2^30 combined segment with validity masks, and VERIFY on
            device — every left row's match flag and joined value checked
            against the generator's closed form, exact match counts.

All duplicates of a key land in one bucket (both sides are cut by the
same side="left" searchsorted on the same splitters), so per-bucket joins
compose exactly. Output rows exist bucket-by-bucket in global KEY order
(the same contract as the out-of-core sort's bucket stream); restoring
original left order is one more out-of-core sort by the carried left
index — the machinery of sort/bigsort.py.

Benchmark data model (device-generated; no host streaming, see
sort/bigsort.py): right keys are index hashes with
the low bit CLEARED; left rows with an even index take some right row's
key (match), odd indices take a low-bit-SET key (miss). Matching is thus
decided by construction, not by hash collision luck — the expected match
set is exactly the even left indices, and every joined value must equal
a hash of the key. Hash collisions among right keys only create
duplicate right keys, which FK last-wins semantics absorb (the value is
a function of the key, so any winner verifies).

Reference contrast: the reference has no joins at all; this is the
query-operator mandate (SURVEY.md §7 step 6) at data sizes its
single-dispatch model could never reach.
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
from tpu_qe.ops.join import join_fk_scan, searchsorted_u64
from tpu_qe.hashing import keygen_hash, murmur_fmix32 as _murmur_fmix32
from tpu_qe.utils.checkpoint import RunState as _RunState
from tpu_qe.table import Table

_ONES = jnp.uint32(0xFFFFFFFF)
_VAL_C = jnp.uint32(0xABCD1234)


def _rkey_of_index(i: jnp.ndarray, seed: int) -> U64:
    """Right key for right row i: index hash with the low bit cleared."""
    k = keygen_hash(i, seed)
    return U64(k.lo & jnp.uint32(0xFFFFFFFE), k.hi)


def _rval_of_key(key: U64) -> jnp.ndarray:
    """Joined value as a closed form of the key (device-verifiable)."""
    return _murmur_fmix32(key.lo ^ key.hi ^ _VAL_C)


def _lkey_of_index(j: jnp.ndarray, n_r: int, seed: int) -> U64:
    """Left key for left row j: even j -> the key of right row
    (j*2654435761 mod n_r) (a guaranteed match); odd j -> a low-bit-SET
    key (a guaranteed miss — all right keys are even-lo)."""
    i = (j * jnp.uint32(2654435761)) % jnp.uint32(n_r)
    hit = _rkey_of_index(i, seed)
    missk = keygen_hash(j, seed + 1)
    miss_lo = missk.lo | jnp.uint32(1)
    even = (j & jnp.uint32(1)) == 0
    return U64(jnp.where(even, hit.lo, miss_lo),
               jnp.where(even, hit.hi, missk.hi))


@functools.partial(jax.jit, static_argnames=("n", "n_r", "seed", "side"))
def _make_sorted_side(n: int, n_r: int, seed: int, side: str):
    """Generate and key-sort one side in a single resident program.

    The right side needs no payload (joined values are a closed form of
    the key) — a 2-operand sort, and 4 bytes/row less HBM."""
    idx = jnp.arange(n, dtype=jnp.uint32)
    if side == "right":
        key = _rkey_of_index(idx, seed)
        hi, lo = jax.lax.sort([key.hi, key.lo], num_keys=2, is_stable=False)
        return lo, hi
    key = _lkey_of_index(idx, n_r, seed)
    hi, lo, pay = jax.lax.sort([key.hi, key.lo, idx], num_keys=3,
                               is_stable=False)
    return lo, hi, pay


@functools.partial(jax.jit, static_argnames=("n_buckets", "per_side"))
def _plan_buckets(llo, lhi, rlo, rhi, n_buckets: int, per_side: int):
    """Union-quantile splitters + exact per-side bucket boundaries."""
    samples = []
    for lo, hi in ((llo, lhi), (rlo, rhi)):
        n = lo.shape[0]
        stride = max(n // per_side, 1)
        sel = (jnp.arange(per_side) * stride) % n
        samples.append((jnp.take(lo, sel), jnp.take(hi, sel)))
    s_lo = jnp.concatenate([s[0] for s in samples])
    s_hi = jnp.concatenate([s[1] for s in samples])
    s_hi, s_lo = jax.lax.sort([s_hi, s_lo], num_keys=2, is_stable=False)
    total = s_lo.shape[0]
    q = (jnp.arange(1, n_buckets) * total) // n_buckets
    sp = U64(s_lo[q], s_hi[q])
    bl = searchsorted_u64(U64(llo, lhi), sp, side="left")
    br = searchsorted_u64(U64(rlo, rhi), sp, side="left")
    return bl, br  # (B-1,) positions per side


def _verify_construction(s_lidx, l_valid, s_llo, s_lhi, out_rv, matched):
    """On-device check of one bucket's join against the generator's
    closed form (shared by the single-chip and distributed bucket
    joiners): matches are exactly the even left indices, and every
    joined value equals f(key). Returns the 4 verification scalars."""
    expect = (s_lidx & jnp.uint32(1)) == 0
    match_ok = jnp.all(~l_valid | (matched == expect))
    want_rv = _rval_of_key(U64(s_llo, s_lhi))
    val_ok = jnp.all(~matched | (out_rv == want_rv))
    n_matched = jnp.sum((matched & l_valid).astype(jnp.uint32))
    n_even = jnp.sum((l_valid & expect).astype(jnp.uint32))
    return (match_ok.astype(jnp.uint32), val_ok.astype(jnp.uint32),
            n_matched, n_even)


def _join_bucket_fn(cap_l: int, cap_r: int, emit: bool = False):
    """Jitted phase-C body: slice one bucket from each sorted side, join,
    verify on device, return scalars (and, with emit, the joined bucket
    stream: per left-slot key/lidx/value/matched/valid device arrays —
    the consumer contract; left slots are key-sorted within the bucket
    because the left side was key-sorted in phase A)."""

    @jax.jit
    def run(st_l, dl_l, sz_l, st_r, dl_r, sz_r,
            llo, lhi, lidx, rlo, rhi):
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
        r_valid = (ar_r >= dl_r.astype(jnp.uint32)) & (
            ar_r < dl_r.astype(jnp.uint32) + sz_r.astype(jnp.uint32))

        rkey = U64(s_rlo, s_rhi)
        rv = _rval_of_key(rkey)
        out, matched = join_fk_scan(
            Table({"lidx": s_lidx}), Table({"rv": rv}),
            U64(s_llo, s_lhi), rkey, l_valid=l_valid, r_valid=r_valid)

        scalars = _verify_construction(
            s_lidx, l_valid, s_llo, s_lhi, out["rv"], matched) + (
            jnp.sum(sz_l.astype(jnp.uint32)),
            jnp.sum(sz_r.astype(jnp.uint32)))
        if not emit:
            return scalars
        return scalars + (s_llo, s_lhi, s_lidx, out["rv"],
                          (matched & l_valid).astype(jnp.uint32),
                          l_valid.astype(jnp.uint32))

    return run


@dataclasses.dataclass(frozen=True)
class BigJoinResult:
    n_l: int
    n_r: int
    seconds: float
    rows_per_s: float          # left rows joined per second
    matched: int               # exact global match count
    match_ok: bool             # every flag equals the construction oracle
    val_ok: bool               # every joined value equals f(key)
    count_ok: bool             # counts: matched == expected, rows == n
    phase_a_s: float
    phase_c_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return self.match_ok and self.val_ok and self.count_ok


class _JoinState(_RunState):
    """Checkpoint state for join_big: persists the bucket plan (both
    sides' boundaries) + per-bucket verification scalars; the sorted
    sides regenerate deterministically (same reasoning as the sort's
    state — see sort/bigsort.py::_RunState)."""

    N_SCALARS = 6  # match_ok, val_ok, n_matched, n_even, rows_l, rows_r

    @staticmethod
    def _path(directory: str) -> str:
        return os.path.join(directory, "bigjoin_state.npz")


def join_big(n_l: int, n_r: int, n_buckets: int | None = None,
             seed: int = 7, samples_per_side: int = 8192,
             verbose: bool = False, consume=None, collect: bool = False,
             checkpoint_dir: str | None = None):
    """Out-of-core FK join of n_l x n_r device-generated rows.

    Lifts join_fk_scan's 2^30 combined-row cap by key-space bucketing;
    every bucket's matches and values are verified on device (exact, by
    construction — see module docstring). Peak HBM ~ (n_l + n_r) * 12 B
    resident plus one bucket's join working set.

    Output materialization (the bigsort bucket-stream contract):
      consume: optional callable consume(b, bucket) invoked per bucket,
        in GLOBAL KEY ORDER, with DEVICE arrays (no host transfer):
        bucket = dict(key=U64 left keys, lidx=original left row index,
        value=joined right value, matched=u32 flag, valid=u32 slot-valid
        flag); slots are the bucket's key-sorted left rows, padded to the
        static left capacity — mask with `valid`. Downstream on-device
        pipelines (e.g. group_aggregate_sorted per bucket) chain from
        here; this is how join output larger than HBM leaves the engine.
      collect: assemble all buckets' VALID left rows on host (small-n
        tests only) — returns (result, dict(key, lidx, value, matched))
        in global key order.

    checkpoint_dir: same resume contract as sort_big — the bucket plan
    and per-bucket scalars persist (atomic npz); a restarted run
    regenerates the sorted sides, loads the plan, and skips completed
    buckets (unless consume/collect asks for their streams again).
    """
    assert n_l < (1 << 32) and n_r < (1 << 32)
    if n_buckets is None:
        # keep each bucket's combined segment well under the 2^30 cap and
        # its join working set bucket-sized
        n_buckets = max(2, int(np.ceil((n_l + n_r) / (1 << 26))))
    meta = np.asarray([n_l, n_r, n_buckets, seed, samples_per_side],
                      np.int64)
    state = (_JoinState.load(checkpoint_dir, meta)
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
    rlo, rhi = right_exec()
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
            state = _JoinState.fresh(checkpoint_dir, meta,
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
        print(f"bigjoin: {n_buckets} buckets, cap_l={cap_l} "
              f"(max {int(sz_l.max())}), cap_r={cap_r} "
              f"(max {int(sz_r.max())})")

    tcm = time.perf_counter()
    emit = consume is not None or collect
    bucket = _join_bucket_fn(cap_l, cap_r, emit=emit)
    z = jnp.int32(0)
    bucket_exec = bucket.lower(z, z, z, z, z, z, llo, lhi, lidx,
                               rlo, rhi).compile()
    compile_s += time.perf_counter() - tcm

    t1 = time.perf_counter()
    skip = set()
    if state is not None and not emit:
        skip = {b for b in range(n_buckets) if state.done[b]}
        if verbose and skip:
            print(f"bigjoin: resuming — {len(skip)}/{n_buckets} buckets "
                  "already joined")
    pending = {}
    ceil_l, ceil_r = max(n_l - cap_l, 0), max(n_r - cap_r, 0)
    for b in range(n_buckets):
        if b in skip:
            continue
        cl = min(st_l[b], ceil_l)
        cr = min(st_r[b], ceil_r)
        out = bucket_exec(
            jnp.int32(cl), jnp.int32(st_l[b] - cl), jnp.int32(sz_l[b]),
            jnp.int32(cr), jnp.int32(st_r[b] - cr), jnp.int32(sz_r[b]),
            llo, lhi, lidx, rlo, rhi)
        if emit:
            out, stream = out[:6], out[6:]
            if consume is not None:
                # consume at dispatch time and drop our stream reference
                # (same HBM-lifetime argument as sort_big): only the
                # consumer's queued programs keep the bucket alive
                s_llo, s_lhi, s_lidx, s_val, s_m, s_v = stream
                consume(b, dict(key=U64(s_llo, s_lhi), lidx=s_lidx,
                                value=s_val, matched=s_m, valid=s_v))
            pending[b] = (out, stream if collect else None)
        else:
            pending[b] = (out, None)
    matched = 0
    expected = 0
    rows_l = 0
    rows_r = 0
    m_ok = True
    v_ok = True
    collected = []
    for b in range(n_buckets):
        if b in skip:
            mo, vo, nm, ne, nl_b, nr_b = [int(v) for v in state.scalars[b]]
        else:
            out, stream = pending[b]
            if collect:
                s_llo, s_lhi, s_lidx, s_val, s_m, s_v = stream
                keep = np.asarray(s_v).astype(bool)
                k64 = (np.asarray(s_lhi).astype(np.uint64)
                       << np.uint64(32)) \
                    | np.asarray(s_llo).astype(np.uint64)
                collected.append((k64[keep], np.asarray(s_lidx)[keep],
                                  np.asarray(s_val)[keep],
                                  np.asarray(s_m)[keep]))
            mo, vo, nm, ne, nl_b, nr_b = [int(np.asarray(x)) for x in out]
            if state is not None:
                state.record(b, [mo, vo, nm, ne, nl_b, nr_b])
        m_ok &= bool(mo)
        v_ok &= bool(vo)
        matched += nm
        expected += ne
        rows_l += nl_b
        rows_r += nr_b
        if verbose:
            print(f"  bucket {b}: {nl_b}+{nr_b} rows, {nm} matched "
                  f"ok={bool(mo) and bool(vo)}")
    t_c = time.perf_counter() - t1

    # exact global counts: every left row in exactly one bucket; the
    # match set is exactly the even left indices
    count_ok = (rows_l == n_l and rows_r == n_r
                and matched == expected == (n_l + 1) // 2)
    dt = t_a + t_b + t_c
    res = BigJoinResult(
        n_l=n_l, n_r=n_r, seconds=dt, rows_per_s=n_l / dt,
        matched=matched, match_ok=m_ok, val_ok=v_ok, count_ok=count_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if collect:
        return res, {
            "key": np.concatenate([c[0] for c in collected]),
            "lidx": np.concatenate([c[1] for c in collected]),
            "value": np.concatenate([c[2] for c in collected]),
            "matched": np.concatenate([c[3] for c in collected]).astype(bool),
        }
    return res
