"""Out-of-core window functions on one device (rows > one program's HBM).

The same composition law that scales windows across devices
(exchange/dwindow.py) scales them past HBM: a window is a segmented scan
over the (partition, order, position)-sorted stream, and segmented scans
compose across any cut through a monoid carry. Here the cuts are the
out-of-core sort's bucket boundaries:

  phase A   R sorted runs, each generated on device from the regenerable
            index hash (partition key / order / value are all closed
            forms of the carried global index) and sorted by the FULL
            window order (key, order, index) — a 4-key lax.sort;
  phase B   one splitter plan on the SAME composite order (lexicographic
            4-plane quantiles + per-run multi-plane searchsorted), so hot
            partitions split across buckets exactly like dwindow's
            devices — capacities stay balanced under any skew;
  phase C   per bucket IN GLOBAL ORDER: merge segments, compute the local
            window planes (ops/window.py segmented sweeps), patch the
            boundary partition with the carry from the previous bucket,
            emit the next carry — a 9-scalar DEVICE vector chained
            program-to-program, so all B buckets queue with no host
            round-trip in the chain.

Fixed verified function set (the benchmark data model): row_number,
rank, running_sum (EXACT u64 pair), lag. On-device verification per
bucket is construction-exact: composite sortedness, per-row closed-form
hash checks (key/order/value are functions of the carried index), and a
full re-derivation of every window column via its sequential recurrence
(rn[i] = same-partition ? rn[i-1]+1 : 1, etc., seamed against the carry
at row 0) — an independent check of the blocked-scan computation path.

Reference contrast: the reference's dataset is 3,000 keys in one
dispatch chain (/root/reference/src/constants.rs:3); this composes the
window family over the same out-of-core machinery as sort/bigsort.py.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.bits import U64
from tpu_qe.hashing import murmur_fmix32, murmur_fmix32_numpy
from tpu_qe.ops.window import _window_sorted_cols
from tpu_qe.utils.checkpoint import RunState

_ONES = jnp.uint32(0xFFFFFFFF)
_O_SALT = 0x6F726472
_V_SALT = 0x76616C75

# fixed verified spec (name, kind, col, fill) — canon order by name
WSPEC = (("cum", "running_sum", "v", 0), ("lg", "lag", "v", 0),
         ("rk", "rank", None, 0), ("rn", "row_number", None, 0))
N_CARRY = 9   # have, lk_lo, lk_hi, lord, cnt, rank, sum_lo, sum_hi, lastv
N_CHECK = 10  # s_ok, h_ok, w_ok, cnt, flo, fhi, f_ord, llo, lhi, l_ord


def _pk(idx: jnp.ndarray, partitions: int, seed: int) -> jnp.ndarray:
    return murmur_fmix32(idx ^ jnp.uint32(seed)) % jnp.uint32(partitions)


def _key_of(idx, partitions: int, seed: int) -> U64:
    pk = _pk(idx, partitions, seed)
    # pk -> u64 key injectively (lo is a bijection of pk), so distinct
    # partitions stay distinct and key order is a permutation of pk order
    return U64(pk * jnp.uint32(2654435761),
               murmur_fmix32(pk ^ jnp.uint32(0x9E3779B9)))


def _ord_of(idx, seed: int) -> jnp.ndarray:
    return murmur_fmix32(idx ^ jnp.uint32(seed ^ _O_SALT))


def _val_of(idx, seed: int) -> jnp.ndarray:
    return murmur_fmix32(idx ^ jnp.uint32(seed ^ _V_SALT))


def rows_numpy(idx: np.ndarray, partitions: int, seed: int = 7):
    """Host twin of the data model (oracle tests): (key64, order, value)."""
    pk = murmur_fmix32_numpy(idx.astype(np.uint32) ^ np.uint32(seed)) \
        % np.uint32(partitions)
    lo = pk * np.uint32(2654435761)
    hi = murmur_fmix32_numpy(pk ^ np.uint32(0x9E3779B9))
    key = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    o = murmur_fmix32_numpy(idx.astype(np.uint32)
                            ^ np.uint32((seed ^ _O_SALT) & 0xFFFFFFFF))
    v = murmur_fmix32_numpy(idx.astype(np.uint32)
                            ^ np.uint32((seed ^ _V_SALT) & 0xFFFFFFFF))
    return key, o, v


@functools.partial(jax.jit, static_argnames=("n_run", "partitions", "seed"))
def _make_run(r: jnp.ndarray, n_run: int, partitions: int, seed: int):
    """Phase A body: generate + sort one run by (key, order, index)."""
    idx = r * jnp.uint32(n_run) + jnp.arange(n_run, dtype=jnp.uint32)
    key = _key_of(idx, partitions, seed)
    o = _ord_of(idx, seed)
    v = _val_of(idx, seed)
    out = jax.lax.sort([key.hi, key.lo, o, idx, v], num_keys=4,
                       is_stable=False)  # idx unique -> deterministic
    return out[1], out[0], out[2], out[3], out[4]  # lo, hi, o, idx, v


def _searchsorted_multi(planes, q_planes):
    """Vectorized lexicographic binary search (side='left') over sorted
    major->minor u32 planes; the 4-plane generalization of
    ops.join.searchsorted_u64 the composite splitter plan needs."""
    m = planes[0].shape[0]
    steps = m.bit_length()
    qshape = q_planes[0].shape
    lo_b = jnp.zeros(qshape, dtype=jnp.int32)
    hi_b = jnp.full(qshape, m, dtype=jnp.int32)

    def probe_less(mid):
        lt = jnp.zeros(qshape, bool)
        for p, q in zip(reversed(planes), reversed(q_planes)):
            pv = jnp.take(p, mid)
            lt = (pv < q) | ((pv == q) & lt)
        return lt

    def body(_, carry):
        lo_b, hi_b = carry
        done = lo_b >= hi_b
        mid = jnp.minimum((lo_b + hi_b) // 2, m - 1)
        go_right = probe_less(mid) & ~done
        return (jnp.where(go_right, mid + 1, lo_b),
                jnp.where(go_right | done, hi_b, mid))

    lo_b, _ = jax.lax.fori_loop(0, steps, body, (lo_b, hi_b))
    return lo_b


@functools.partial(jax.jit, static_argnames=("n_buckets", "per_run"))
def _plan(runs, n_buckets: int, per_run: int):
    """Phase B: composite (key, order, index) splitters + per-run segment
    boundaries — quantiles on the full window order, so a hot partition
    splits across buckets (the carry chain composes it) instead of
    landing whole in one bucket and blowing its capacity."""
    samples = [[] for _ in range(4)]
    for lo, hi, o, idx, _v in runs:
        n = lo.shape[0]
        stride = max(n // per_run, 1)
        sel = (jnp.arange(per_run) * stride) % n
        for j, p in enumerate((hi, lo, o, idx)):
            samples[j].append(jnp.take(p, sel))
    g = jax.lax.sort([jnp.concatenate(s) for s in samples], num_keys=4,
                     is_stable=False)
    total = g[0].shape[0]
    q = (jnp.arange(1, n_buckets) * total) // n_buckets
    sp = [p[q] for p in g]  # (B-1,) per plane, hi/lo/o/idx
    bounds = [
        _searchsorted_multi((hi, lo, o, idx), sp)
        for lo, hi, o, idx, _v in runs
    ]
    return sp[0], sp[1], jnp.stack(bounds)  # (R, B-1)


def _u64_add(alo, ahi, blo, bhi):
    lo = alo + blo
    return lo, ahi + bhi + (lo < blo).astype(jnp.uint32)


def window_core(shi, slo, so, sidx, sv, n_valid, carry,
                partitions: int, seed: int):
    """Window planes + carry patch + construction-exact verification over
    one SORTED (key, order, index) stream with sentinel pads at the tail
    (bit 31 of the index plane is the pad flag).

    The shared phase-C core of the out-of-core window at both scales —
    window_big's sequential bucket chain and dbigwindow's per-device
    bucket rounds (whose incoming device carry comes from the O(D)
    pre-pass chain). Returns (checks 10-tuple, carry_out (9,) u32,
    planes (rn, rk, cum_lo, cum_hi, lg))."""
    spad = (sidx >> jnp.uint32(31)) > 0
    m = slo.shape[0]
    pos = jnp.arange(m, dtype=jnp.uint32)
    valid = pos < n_valid

    def prev(x):
        return jnp.concatenate([jnp.zeros((1,), x.dtype), x[:-1]])

    first = pos == 0
    is_new = (first | (slo != prev(slo)) | (shi != prev(shi))
              | (spad & ~prev(spad)))
    order_new = is_new | (so != prev(so))
    is_last = jnp.concatenate([is_new[1:], jnp.ones((1,), bool)])

    out, aux = _window_sorted_cols(WSPEC, {"v": sv}, pos, is_new,
                                   order_new, is_last, need_aux=True)
    part_start, run_start = aux["part_start"], aux["run_start"]

    # --- patch the boundary partition with the previous bucket ------
    have, plk_lo, plk_hi, plord = carry[0], carry[1], carry[2], carry[3]
    c_cnt, c_rank = carry[4], carry[5]
    c_slo, c_shi, c_lv = carry[6], carry[7], carry[8]
    cont = (have > 0) & (slo[0] == plk_lo) & (shi[0] == plk_hi)
    cont_o = cont & (so[0] == plord)
    head = valid & (part_start == 0) & cont
    u0 = jnp.uint32(0)
    rn = out["rn"] + jnp.where(head, c_cnt, u0)
    in_head_run = head & (run_start == 0) & cont_o
    rk = jnp.where(in_head_run, c_rank,
                   out["rk"] + jnp.where(head, c_cnt, u0))
    nlo, nhi = _u64_add(out["cum"].lo, out["cum"].hi, c_slo, c_shi)
    cum_lo = jnp.where(head, nlo, out["cum"].lo)
    cum_hi = jnp.where(head, nhi, out["cum"].hi)
    lg = jnp.where(first & cont, c_lv, out["lg"])

    # --- construction-exact on-device verification -------------------
    # composite (key, order, index) order over the valid prefix
    pr_hi, pr_lo = prev(shi), prev(slo)
    pr_o, pr_i = prev(so), prev(sidx)
    ge = ((shi > pr_hi)
          | ((shi == pr_hi)
             & ((slo > pr_lo)
                | ((slo == pr_lo)
                   & ((so > pr_o)
                      | ((so == pr_o) & (sidx >= pr_i)))))))
    sorted_ok = jnp.all(ge | first | ~valid)
    # every row's key/order/value are the generator's closed forms of
    # its own carried index — rows move as units or this fails
    want_k = _key_of(sidx, partitions, seed)
    hash_ok = jnp.all(~valid | ((slo == want_k.lo) & (shi == want_k.hi)
                                & (so == _ord_of(sidx, seed))
                                & (sv == _val_of(sidx, seed))))
    # full re-derivation of every window column via its sequential
    # recurrence (independent of the blocked-scan compute path),
    # seamed against the carry at row 0
    pv = prev(sv)
    rn_want = jnp.where(is_new, jnp.uint32(1), prev(rn) + 1)
    rn_want = jnp.where(
        first, jnp.where(cont, c_cnt + 1, jnp.uint32(1)), rn_want)
    rk_want = jnp.where(is_new, jnp.uint32(1),
                        jnp.where(order_new, rn, prev(rk)))
    rk_want = jnp.where(
        first, jnp.where(cont_o, c_rank,
                         jnp.where(cont, c_cnt + 1, jnp.uint32(1))),
        rk_want)
    alo, ahi = _u64_add(prev(cum_lo), prev(cum_hi), sv,
                        jnp.zeros_like(sv))
    cum_want_lo = jnp.where(is_new, sv, alo)
    cum_want_hi = jnp.where(is_new, u0, ahi)
    slo0, shi0 = _u64_add(c_slo, c_shi, sv, jnp.zeros_like(sv))
    cum_want_lo = jnp.where(first & cont, slo0, cum_want_lo)
    cum_want_hi = jnp.where(first & cont, shi0, cum_want_hi)
    lg_want = jnp.where(is_new, u0, pv)
    lg_want = jnp.where(first, jnp.where(cont, c_lv, u0), lg_want)
    window_ok = jnp.all(
        ~valid | ((rn == rn_want) & (rk == rk_want)
                  & (cum_lo == cum_want_lo) & (cum_hi == cum_want_hi)
                  & (lg == lg_want)))

    # --- carry out (pass through unchanged on an empty bucket) -------
    li = jnp.maximum(n_valid, 1) - 1
    nonempty = n_valid > 0

    def sel(new, old):
        return jnp.where(nonempty, new, old)

    carry_out = jnp.stack([
        sel(jnp.uint32(1), have),
        sel(slo[li], plk_lo), sel(shi[li], plk_hi),
        sel(so[li], plord),
        sel(rn[li], c_cnt), sel(rk[li], c_rank),
        sel(cum_lo[li], c_slo), sel(cum_hi[li], c_shi),
        sel(sv[li], c_lv),
    ])
    checks = (sorted_ok.astype(jnp.uint32),
              hash_ok.astype(jnp.uint32),
              window_ok.astype(jnp.uint32),
              n_valid, slo[0], shi[0], so[0],
              slo[li], shi[li], so[li])
    return checks, carry_out, (rn, rk, cum_lo, cum_hi, lg)


def _bucket_fn(n_runs: int, cap_seg: int, partitions: int, seed: int,
               collect: bool = False):
    """Phase-C body for one bucket: merge the runs' segments, then the
    shared window core (compute + carry patch + verification)."""

    @jax.jit
    def bucket(starts, deltas, sizes, carry, *run_arrays):
        segs = [[] for _ in range(5)]
        ar = jnp.arange(cap_seg, dtype=jnp.uint32)
        for r in range(n_runs):
            cols = run_arrays[5 * r: 5 * (r + 1)]
            d = deltas[r].astype(jnp.uint32)
            in_seg = (ar >= d) & (ar < d + sizes[r].astype(jnp.uint32))
            for c in range(5):
                sl = jax.lax.dynamic_slice(cols[c], (starts[r],),
                                           (cap_seg,))
                # pads: all planes all-ones -> sorts after every real row
                # (real idx < 2^31, so bit 31 of the idx plane IS the pad
                # flag); value pad 0
                fill = jnp.uint32(0) if c == 4 else _ONES
                segs[c].append(jnp.where(in_seg, sl, fill))
        lo, hi, o, ridx, v = [jnp.concatenate(s) for s in segs]
        n_valid = jnp.sum(sizes).astype(jnp.uint32)
        res = jax.lax.sort([hi, lo, o, ridx, v], num_keys=4,
                           is_stable=False)
        shi, slo, so, sidx, sv = res
        checks, carry_out, planes = window_core(
            shi, slo, so, sidx, sv, n_valid, carry, partitions, seed)
        if collect:
            return checks + (carry_out, slo, shi, so, sidx, sv) + planes
        return checks + (carry_out,)

    return bucket


@dataclasses.dataclass(frozen=True)
class BigWindowResult:
    n: int
    partitions: int
    seconds: float
    rows_per_s: float
    sorted_ok: bool
    hash_ok: bool
    window_ok: bool
    count_ok: bool
    boundary_ok: bool
    phase_a_s: float
    phase_c_s: float
    compile_s: float

    @property
    def all_ok(self) -> bool:
        return (self.sorted_ok and self.hash_ok and self.window_ok
                and self.count_ok and self.boundary_ok)


def window_big(n: int, partitions: int | None = None,
               run_size: int = 1 << 26, n_buckets: int | None = None,
               seed: int = 7, samples_per_run: int = 4096,
               verbose: bool = False, collect: bool = False,
               checkpoint_dir: str | None = None):
    """Out-of-core window (rn/rank/exact-u64 running sum/lag) over n rows.

    n must be a multiple of run_size and < 2^31 (the pad flag rides bit
    31 of the index plane). Peak HBM ~ n*20 bytes resident runs + one
    bucket working set. The B bucket programs chain their 9-scalar carry
    as DEVICE arrays, so the whole phase C queues without host round
    trips (checkpointing opts into per-bucket readbacks to persist the
    carry). checkpoint_dir: resume replays the done PREFIX of buckets
    (the carry chain is sequential) from persisted scalars + carries.
    collect=True (test-only) returns all rows + window columns.
    """
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 31), "pad flag rides bit 31 of the index plane"
    if partitions is None:
        partitions = max(n // 1024, 1)
    n_runs = n // run_size
    if n_buckets is None:
        n_buckets = max(2, int(np.ceil(n / (1 << 26))))
    meta = np.asarray([n, partitions, run_size, n_buckets, seed,
                       samples_per_run, 0xB16], dtype=np.int64)
    state = (RunState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])
    run_exec = _make_run.lower(jnp.uint32(0), n_run=run_size,
                               partitions=partitions, seed=seed).compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    runs = [run_exec(jnp.uint32(r)) for r in range(n_runs)]
    for run in runs:
        np.asarray(run[0][-1:])  # fence phase A
    t_a = time.perf_counter() - t0

    if state is not None:
        bounds = state.bounds
        t_b = 0.0
    else:
        tcp = time.perf_counter()
        plan_exec = _plan.lower(runs, n_buckets=n_buckets,
                                per_run=samples_per_run).compile()
        compile_s += time.perf_counter() - tcp
        t_b0 = time.perf_counter()
        _, _, bounds = plan_exec(runs)
        bounds = np.asarray(bounds)
        t_b = time.perf_counter() - t_b0
        if checkpoint_dir is not None:
            state = RunState.fresh(checkpoint_dir, meta, bounds, n_buckets,
                                   n_scalars=N_CHECK + N_CARRY)

    zeros = np.zeros((n_runs, 1), dtype=bounds.dtype)
    full = np.full((n_runs, 1), run_size, dtype=bounds.dtype)
    starts = np.concatenate([zeros, bounds], axis=1)
    ends = np.concatenate([bounds, full], axis=1)
    sizes = (ends - starts).astype(np.int32)
    quantum = 1 << 20 if run_size >= (1 << 22) else 256
    cap_seg = -(-max(int(sizes.max()), 1) // quantum) * quantum
    cap_seg = min(cap_seg, run_size)
    if verbose:
        print(f"bigwindow: {n_runs} runs x {run_size}, {n_buckets} "
              f"buckets, cap_seg={cap_seg} (max demand "
              f"{int(sizes.max())})")

    bucket = _bucket_fn(n_runs, cap_seg, partitions, seed, collect=collect)
    flat_runs = [a for r in runs for a in r]
    tc1 = time.perf_counter()
    ex_i = jnp.zeros(n_runs, jnp.int32)
    ex_c = jnp.zeros(N_CARRY, jnp.uint32)
    bucket_exec = bucket.lower(ex_i, ex_i, ex_i, ex_c,
                               *flat_runs).compile()
    compile_s += time.perf_counter() - tc1

    t1 = time.perf_counter()
    scal = np.zeros((n_buckets, N_CHECK), np.int64)
    carry = jnp.zeros(N_CARRY, jnp.uint32)
    start_b = 0
    if state is not None and not collect:
        # resume: replay the DONE PREFIX (the carry chain is sequential)
        while start_b < n_buckets and state.done[start_b]:
            scal[start_b] = state.scalars[start_b, :N_CHECK]
            start_b += 1
        if start_b > 0:
            carry = jnp.asarray(
                state.scalars[start_b - 1, N_CHECK:].astype(np.uint32))
            if verbose:
                print(f"bigwindow: resuming — {start_b}/{n_buckets} "
                      "buckets replayed from checkpoint")
    pending = {}
    for b in range(start_b, n_buckets):
        raw = starts[:, b].astype(np.int64)
        clamped = np.minimum(raw, max(run_size - cap_seg, 0))
        deltas = (raw - clamped).astype(np.int32)
        out = bucket_exec(jnp.asarray(clamped.astype(np.int32)),
                          jnp.asarray(deltas),
                          jnp.asarray(sizes[:, b].astype(np.int32)),
                          carry, *flat_runs)
        carry = out[N_CHECK]  # device array: chains with no readback
        pending[b] = out
        if state is not None:
            # checkpointing opts into a per-bucket fence: the carry must
            # be persisted for the resume prefix to be meaningful
            vals = [int(np.asarray(x)) for x in out[:N_CHECK]]
            cvals = [int(x) for x in np.asarray(out[N_CHECK])]
            scal[b] = vals
            state.record(b, vals + cvals)
    collected = []
    for b, out in pending.items():
        if state is None:
            scal[b] = [int(np.asarray(x)) for x in out[:N_CHECK]]
        if collect:
            cnt_b = int(scal[b, 3])
            collected.append(tuple(np.asarray(a)[:cnt_b]
                                   for a in out[N_CHECK + 1:]))
        if verbose:
            print(f"  bucket {b}: {scal[b, 3]} rows "
                  f"sorted={bool(scal[b, 0])} hash={bool(scal[b, 1])} "
                  f"window={bool(scal[b, 2])}")
    t_c = time.perf_counter() - t1

    total = 0
    all_sorted = all_hash = all_window = boundary_ok = True
    prev_last = None
    for b in range(n_buckets):
        s_ok, h_ok, w_ok, cnt, flo, fhi, fo, llo, lhi, lo_ = scal[b]
        all_sorted &= bool(s_ok)
        all_hash &= bool(h_ok)
        all_window &= bool(w_ok)
        total += int(cnt)
        if prev_last is not None and cnt > 0:
            p_lo, p_hi, p_o = prev_last
            le = (p_hi, p_lo, p_o) <= (fhi, flo, fo)
            boundary_ok &= bool(le)
        if cnt > 0:
            prev_last = (llo, lhi, lo_)
    dt = t_a + t_b + t_c
    res = BigWindowResult(
        n=n, partitions=partitions, seconds=dt, rows_per_s=n / dt,
        sorted_ok=all_sorted, hash_ok=all_hash, window_ok=all_window,
        count_ok=(total == n), boundary_ok=boundary_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if collect:
        cat = [np.concatenate([c[j] for c in collected])
               for j in range(10)]
        slo, shi, so, sidx, sv, rn, rk, clo, chi, lg = cat
        keys = slo.astype(np.uint64) | (shi.astype(np.uint64)
                                        << np.uint64(32))
        cum = clo.astype(np.uint64) | (chi.astype(np.uint64)
                                       << np.uint64(32))
        return res, dict(key=keys, order=so, idx=sidx, value=sv,
                         rn=rn, rk=rk, cum=cum, lg=lg)
    return res
