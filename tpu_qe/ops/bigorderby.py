"""Out-of-core multi-column ORDER BY: the external sample sort over
transformed key planes.

ops/orderby.py orders one resident program's rows by mixed-type,
mixed-direction key lists via order-preserving u32 bit planes (DESC =
inverted bits — a bijection, so lexicographic order on the TRANSFORMED
planes IS the requested order). That reduction is exactly what lets the
1B-row external sort machinery (sort/bigsort.py) generalize: run it on
the transformed planes and multi-column DESC/ASC ordering falls out of
the same three phases —

  phase A   per run: generate the table chunk on device, ONE local
            lexicographic sort by (transformed planes..., row index)
            (the unique index buys SQL stability from an unstable sort
            AND makes all-ones a safe pad);
  phase B   composite splitters: strided samples over every run's full
            (planes..., index) order -> global bucket quantiles ->
            per-run segment boundaries (the multi-plane searchsorted of
            ops/bigwindow.py — hot key runs split across buckets by the
            index plane);
  phase C   per bucket: dynamic-slice one segment per run, pad with
            all-ones sentinels, one sort of the concatenation, VERIFY on
            device, and chain a (K+2)-scalar carry (the bucket's last
            composite row + an exact u64 running index sum) as DEVICE
            arrays — the whole phase queues with zero host round trips.

On-device verification per bucket: full lexicographic sortedness of the
valid prefix; every row's key planes re-derived from its carried index
(each output row is a genuine input row); exact counts; cross-bucket
boundary order via the carry; and a permutation certificate — the u64
pair sum of carried indices over all buckets must equal n(n-1)/2.

Benchmark data model (numpy-twinned for oracle tests): column a is a
u64 with `a_card` distinct values (hash-derived, hi a bijection of lo),
column b a full-range signed i32, payload the row index; the driver
orders by (a DESC, b ASC) — the mixed-direction shape the in-core
operator ships.

Reference contrast: the reference sorts a single u64 plane in one
queue submit (reference src/main.rs:60-74,727); this is the SQL
ORDER BY surface at data sizes beyond single-pass reach.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.hashing import murmur_fmix32, murmur_fmix32_numpy
from tpu_qe.ops.bigwindow import _searchsorted_multi

_ONES = jnp.uint32(0xFFFFFFFF)
_A_SALT = 0x0A0A0A0A
_B_SALT = 0x1B1B1B1B
N_PLANES = 3   # transformed: ~a_hi, ~a_lo, sortable(b)
N_COLS = N_PLANES + 2  # + index + payload


def _cols_of(idx: jnp.ndarray, a_card: int, seed: int):
    """TRANSFORMED key planes (a DESC as inverted bits, b ASC as
    sign-flipped i32 bits) + payload for row idx."""
    alo = murmur_fmix32(idx ^ jnp.uint32(seed ^ _A_SALT)) \
        % jnp.uint32(a_card)
    ahi = murmur_fmix32(alo ^ jnp.uint32(0x9E3779B9))
    b = murmur_fmix32(idx ^ jnp.uint32(seed ^ _B_SALT))
    pay = murmur_fmix32(idx ^ jnp.uint32(seed ^ 0x2C2C2C2C))
    t1, t2 = ~ahi, ~alo                       # a DESC
    t3 = b ^ jnp.uint32(0x80000000)           # b as i32, ASC
    return t1, t2, t3, pay


def rows_numpy(idx: np.ndarray, a_card: int, seed: int = 7):
    """Host twin: (a u64, b i32, pay u32) in ORIGINAL (untransformed)
    values — oracle tests sort these with numpy."""
    idx = idx.astype(np.uint32)
    alo = murmur_fmix32_numpy(
        idx ^ np.uint32((seed ^ _A_SALT) & 0xFFFFFFFF)) % np.uint32(a_card)
    ahi = murmur_fmix32_numpy(alo ^ np.uint32(0x9E3779B9))
    a = alo.astype(np.uint64) | (ahi.astype(np.uint64) << np.uint64(32))
    b = murmur_fmix32_numpy(
        idx ^ np.uint32((seed ^ _B_SALT) & 0xFFFFFFFF)).view(np.int32)
    pay = murmur_fmix32_numpy(idx ^ np.uint32((seed ^ 0x2C2C2C2C)
                                              & 0xFFFFFFFF))
    return a, b, pay


@functools.partial(jax.jit, static_argnames=("n_run", "a_card", "seed"))
def _make_run(r: jnp.ndarray, n_run: int, a_card: int, seed: int):
    idx = r * jnp.uint32(n_run) + jnp.arange(n_run, dtype=jnp.uint32)
    t1, t2, t3, pay = _cols_of(idx, a_card, seed)
    out = jax.lax.sort([t1, t2, t3, idx, pay], num_keys=4,
                       is_stable=False)
    return out  # (t1, t2, t3, idx, pay) sorted


@functools.partial(jax.jit, static_argnames=("n_buckets", "per_run"))
def _plan(runs, n_buckets: int, per_run: int):
    samples = [[] for _ in range(4)]
    for cols in runs:
        n = cols[0].shape[0]
        stride = max(n // per_run, 1)
        sel = (jnp.arange(per_run) * stride) % n
        for j in range(4):
            samples[j].append(jnp.take(cols[j], sel))
    g = jax.lax.sort([jnp.concatenate(s) for s in samples], num_keys=4,
                     is_stable=False)
    total = g[0].shape[0]
    q = (jnp.arange(1, n_buckets) * total) // n_buckets
    sp = [p[q] for p in g]
    bounds = [_searchsorted_multi(cols[:4], sp) for cols in runs]
    return jnp.stack(bounds)  # (R, B-1)


def _u64_add(alo, ahi, blo, bhi):
    lo = alo + blo
    return lo, ahi + bhi + (lo < blo).astype(jnp.uint32)


N_CARRY = 6   # prev-last (t1, t2, t3, idx) + running idx-sum (lo, hi)
N_CHECK = 4   # s_ok, h_ok, b_ok, cnt


def _bucket_fn(n_runs: int, cap_seg: int, a_card: int, seed: int,
               collect: bool = False):
    @jax.jit
    def bucket(starts, deltas, sizes, carry, *run_arrays):
        segs = [[] for _ in range(N_COLS)]
        ar = jnp.arange(cap_seg, dtype=jnp.uint32)
        for r in range(n_runs):
            cols = run_arrays[N_COLS * r: N_COLS * (r + 1)]
            d = deltas[r].astype(jnp.uint32)
            in_seg = (ar >= d) & (ar < d + sizes[r].astype(jnp.uint32))
            for c in range(N_COLS):
                sl = jax.lax.dynamic_slice(cols[c], (starts[r],),
                                           (cap_seg,))
                fill = jnp.uint32(0) if c == N_COLS - 1 else _ONES
                segs[c].append(jnp.where(in_seg, sl, fill))
        t1, t2, t3, ridx, pay = [jnp.concatenate(s) for s in segs]
        n_valid = jnp.sum(sizes).astype(jnp.uint32)
        st1, st2, st3, sidx, spay = jax.lax.sort(
            [t1, t2, t3, ridx, pay], num_keys=4, is_stable=False)
        m = st1.shape[0]
        pos = jnp.arange(m, dtype=jnp.uint32)
        valid = pos < n_valid

        def prev(x):
            return jnp.concatenate([jnp.zeros((1,), x.dtype), x[:-1]])

        # full lexicographic sortedness of the valid prefix, including
        # the index tie-break (stability witness)
        p1, p2, p3, p4 = prev(st1), prev(st2), prev(st3), prev(sidx)
        lt = jnp.zeros(m, bool)
        for pv, cv in ((p4, sidx), (p3, st3), (p2, st2), (p1, st1)):
            lt = (pv < cv) | ((pv == cv) & lt)
        s_ok = jnp.all(jnp.where(valid & (pos > 0), lt, True))
        # cross-bucket boundary: the carry's last composite < our first
        c1, c2, c3, c4 = carry[0], carry[1], carry[2], carry[3]
        blt = jnp.zeros((), bool)
        for pv, cv in ((c4, sidx[0]), (c3, st3[0]), (c2, st2[0]),
                       (c1, st1[0])):
            blt = (pv < cv) | ((pv == cv) & blt)
        b_ok = blt | (n_valid == 0)
        # every row re-derives its planes from its carried index
        w1, w2, w3, wpay = _cols_of(sidx, a_card, seed)
        h_ok = jnp.all(jnp.where(
            valid, (st1 == w1) & (st2 == w2) & (st3 == w3)
            & (spay == wpay), True))
        # exact u64 running index sum (permutation certificate; u32
        # pair — x64 stays off, see segscan.cumsum_u64_pair)
        from tpu_qe.ops.segscan import cumsum_u64_pair
        clo, chi = cumsum_u64_pair(jnp.where(valid, sidx, 0))
        acc_lo, acc_hi = _u64_add(carry[4], carry[5], clo[-1], chi[-1])
        li = jnp.maximum(n_valid, 1) - 1
        new_carry = jnp.stack([
            jnp.where(n_valid > 0, st1[li], c1),
            jnp.where(n_valid > 0, st2[li], c2),
            jnp.where(n_valid > 0, st3[li], c3),
            jnp.where(n_valid > 0, sidx[li], c4),
            acc_lo, acc_hi])
        checks = (s_ok, h_ok, b_ok, n_valid)
        if collect:
            return checks + (new_carry, st1, st2, st3, sidx, spay)
        return checks + (new_carry,)

    return bucket


@dataclasses.dataclass(frozen=True)
class BigOrderByResult:
    n: int
    a_card: int
    seconds: float
    rows_per_s: float
    sorted_ok: bool
    hash_ok: bool
    boundary_ok: bool
    count_ok: bool
    perm_ok: bool
    phase_a_s: float
    phase_c_s: float
    compile_s: float

    @property
    def all_ok(self) -> bool:
        return (self.sorted_ok and self.hash_ok and self.boundary_ok
                and self.count_ok and self.perm_ok)


def order_by_big(n: int, a_card: int | None = None,
                 run_size: int = 1 << 26, n_buckets: int | None = None,
                 seed: int = 7, samples_per_run: int = 4096,
                 verbose: bool = False, collect: bool = False):
    """Out-of-core ORDER BY a DESC, b ASC over n device-generated rows
    (see module docstring). n must be a multiple of run_size, < 2^31."""
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 31), n
    if a_card is None:
        a_card = max(n // 256, 1)
    n_runs = n // run_size
    if n_buckets is None:
        n_buckets = max(2, int(np.ceil(n / (1 << 26))))

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])
    run_exec = _make_run.lower(jnp.uint32(0), n_run=run_size,
                               a_card=a_card, seed=seed).compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    runs = [run_exec(jnp.uint32(r)) for r in range(n_runs)]
    for run in runs:
        np.asarray(run[0][-1:])  # fence phase A
    t_a = time.perf_counter() - t0

    tcp = time.perf_counter()
    plan_exec = _plan.lower(runs, n_buckets=n_buckets,
                            per_run=samples_per_run).compile()
    compile_s += time.perf_counter() - tcp
    t_b0 = time.perf_counter()
    bounds = np.asarray(plan_exec(runs))
    t_b = time.perf_counter() - t_b0

    zeros = np.zeros((n_runs, 1), dtype=bounds.dtype)
    full = np.full((n_runs, 1), run_size, dtype=bounds.dtype)
    starts = np.concatenate([zeros, bounds], axis=1)
    ends = np.concatenate([bounds, full], axis=1)
    sizes = (ends - starts).astype(np.int32)
    quantum = 1 << 20 if run_size >= (1 << 22) else 256
    cap_seg = -(-max(int(sizes.max()), 1) // quantum) * quantum
    cap_seg = min(cap_seg, run_size)
    if verbose:
        print(f"bigorderby: {n_runs} runs x {run_size}, {n_buckets} "
              f"buckets, cap_seg={cap_seg} (max {int(sizes.max())})")

    bucket = _bucket_fn(n_runs, cap_seg, a_card, seed, collect=collect)
    flat_runs = [a for r in runs for a in r]
    tcb = time.perf_counter()
    b_exec = bucket.lower(
        jnp.asarray(starts[:, 0]),
        jnp.zeros(n_runs, jnp.int32), jnp.asarray(sizes[:, 0]),
        jnp.zeros(N_CARRY, jnp.uint32), *flat_runs).compile()
    compile_s += time.perf_counter() - tcb

    t_c0 = time.perf_counter()
    # bucket 0's boundary check compares against this zero carry and is
    # excluded on the host below (no predecessor exists)
    carry = jnp.zeros(N_CARRY, dtype=jnp.uint32)
    outs = []
    for b in range(n_buckets):
        # dynamic_slice CLAMPS out-of-bounds starts downward (CLAUDE.md)
        # — pre-clamp on host and mask by the residual delta instead
        raw = starts[:, b].astype(np.int64)
        clamped = np.minimum(raw, max(run_size - cap_seg, 0))
        deltas = (raw - clamped).astype(np.int32)
        out = b_exec(jnp.asarray(clamped.astype(np.int32)),
                     jnp.asarray(deltas),
                     jnp.asarray(sizes[:, b]), carry, *flat_runs)
        carry = out[N_CHECK]
        outs.append(out)
    # read back check scalars (the readback is the fence)
    s_ok = all(bool(np.asarray(o[0])) for o in outs)
    h_ok = all(bool(np.asarray(o[1])) for o in outs)
    b_ok = all(bool(np.asarray(o[2])) for o in outs[1:])  # bucket 0 vs 0s
    cnt = sum(int(np.asarray(o[3])) for o in outs)
    fin = np.asarray(carry)
    isum = int(fin[4]) | (int(fin[5]) << 32)
    perm_ok = isum == n * (n - 1) // 2
    t_c = time.perf_counter() - t_c0

    secs = t_a + t_b + t_c
    res = BigOrderByResult(
        n=n, a_card=a_card, seconds=secs, rows_per_s=n / secs,
        sorted_ok=s_ok, hash_ok=h_ok, boundary_ok=b_ok,
        count_ok=cnt == n, perm_ok=perm_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if collect:
        t1 = np.concatenate([np.asarray(o[N_CHECK + 1])[
            : int(np.asarray(o[3]))] for o in outs])
        t2 = np.concatenate([np.asarray(o[N_CHECK + 2])[
            : int(np.asarray(o[3]))] for o in outs])
        t3 = np.concatenate([np.asarray(o[N_CHECK + 3])[
            : int(np.asarray(o[3]))] for o in outs])
        ridx = np.concatenate([np.asarray(o[N_CHECK + 4])[
            : int(np.asarray(o[3]))] for o in outs])
        pay = np.concatenate([np.asarray(o[N_CHECK + 5])[
            : int(np.asarray(o[3]))] for o in outs])
        # untransform: a = (~t1, ~t2), b = t3 ^ signbit
        a = ((~t2).astype(np.uint64)
             | ((~t1).astype(np.uint64) << np.uint64(32)))
        b = (t3 ^ np.uint32(0x80000000)).view(np.int32)
        return res, {"a": a, "b": b, "idx": ridx, "pay": pay}
    return res
