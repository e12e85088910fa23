"""Out-of-core single-device sort: the 1B-key north-star config.

BASELINE.json's north star is sorting 1B u64 keys + u32 payload on one
device. 1B rows = 12 GB of operands; with sort workspace a single
lax.sort needs several times that. The design is a fully
DEVICE-RESIDENT external sample sort over device-generated data (no host
streaming; whether streaming real data from host memory keeps up is an
open measurement):

  phase A (runs)   generate each 64M-row chunk on device from a
                   regenerable index hash (key = murmur2x32(i) — no input
                   array ever exists) and sort it with the engine's
                   tiebreak sort; R sorted runs stay resident (12 GB).
  phase B (plan)   strided samples from every run -> device-sorted global
                   splitters at the B-quantiles; per-run segment
                   boundaries via searchsorted_u64; ~R*B ints read back.
                   Host sizes the static segment capacity to the EXACT
                   measured demand (plan-then-execute, same discipline as
                   the distributed exchange).
  phase C (merge)  per output bucket: dynamic-slice one segment from each
                   run, mask tails with all-ones sentinels, one sort of
                   the concatenation, then VERIFY on device and read back
                   only scalars: full (not sampled) sortedness, per-row
                   key == hash(payload) (each output row is a genuine
                   input pair), exact counts, payload sum/sum-of-squares
                   (permutation evidence), and bucket boundary keys
                   (cross-bucket global order).

The sorted output exists bucket-by-bucket in HBM; nothing but the check
scalars crosses to the host. Rate = n / wall(A+B+C), every phase ended by
its scalar readbacks.

Reference contrast: the reference sorts 3,000 keys in one dispatch chain
(/root/reference/src/constants.rs:3); this module is the scale-out of the
same sorted-key-stream contract to 333,000x that size on one chip.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.bits import U64
from tpu_qe.hashing import keygen_hash, keygen_hash_numpy, murmur_fmix32
from tpu_qe.utils.checkpoint import RunState
from tpu_qe.ops.join import searchsorted_u64

_ONES = jnp.uint32(0xFFFFFFFF)


# moved to the leaf module tpu_qe.hashing (the out-of-core family imports
# them there without cycling through tpu_qe.ops); legacy names kept
_murmur_fmix32 = murmur_fmix32


def _value_col(idx: jnp.ndarray, j: int, seed: int) -> jnp.ndarray:
    """Extra payload column j for row idx — regenerable (verifiable as
    a function of the carried index) but CARRIED through every sort and
    exchange like real table data, so its bandwidth cost is honest."""
    return murmur_fmix32(idx ^ jnp.uint32((0xA5A5A5A5 + 0x1003F * j)
                                          ^ seed))


def _value_col_numpy(idx: np.ndarray, j: int, seed: int = 7) -> np.ndarray:
    from tpu_qe.hashing import murmur_fmix32_numpy
    return murmur_fmix32_numpy(
        idx.astype(np.uint32)
        ^ np.uint32(((0xA5A5A5A5 + 0x1003F * j) ^ seed) & 0xFFFFFFFF))


@functools.partial(jax.jit, static_argnames=("n_run", "seed",
                                             "payload_cols"))
def _make_sorted_run(r: jnp.ndarray, n_run: int, seed: int,
                     payload_cols: int = 1):
    """Generate chunk r's rows and sort them (phase A body).

    payload_cols > 1 appends carried value columns (table-shaped rows):
    operands 4..3+P ride the same 3-key tiebreak sort."""
    idx = r * jnp.uint32(n_run) + jnp.arange(n_run, dtype=jnp.uint32)
    key = keygen_hash(idx, seed)
    vals = [_value_col(idx, j, seed) for j in range(payload_cols - 1)]
    # tiebreak sort: payload is the unique global index (driver.py
    # BEST_UNIQUE_PAYLOAD_BACKEND rationale)
    out = jax.lax.sort([key.hi, key.lo, idx] + vals, num_keys=3,
                       is_stable=False)
    return (out[1], out[0], out[2]) + tuple(out[3:])


@functools.partial(jax.jit, static_argnames=("n_runs", "run_size",
                                             "per_run", "n_buckets",
                                             "seed"))
def _plan_splitters_from_generator(n_runs: int, run_size: int,
                                   per_run: int, n_buckets: int,
                                   seed: int):
    """Partition-first phase B0: splitters from GENERATED samples.

    Keys are hash-of-index, so strided global samples generate directly
    — no run needs to exist yet. One tiny sort of R*per_run samples
    yields the same B-quantile splitters _plan_splitters would compute
    from the sorted runs."""
    stride = max(run_size // per_run, 1)
    idxs = [jnp.uint32(r * run_size)
            + (jnp.arange(per_run, dtype=jnp.uint32)
               * jnp.uint32(stride)) % jnp.uint32(run_size)
            for r in range(n_runs)]
    key = keygen_hash(jnp.concatenate(idxs), seed)
    s_hi, s_lo = jax.lax.sort([key.hi, key.lo], num_keys=2,
                              is_stable=False)
    total = s_lo.shape[0]
    q = (jnp.arange(1, n_buckets) * total) // n_buckets
    return s_lo[q], s_hi[q]            # (B-1,) ascending splitters


@functools.partial(jax.jit, static_argnames=("n_run", "seed",
                                             "payload_cols",
                                             "n_buckets"))
def _make_bucketed_run(r: jnp.ndarray, sp_lo, sp_hi, n_run: int,
                       seed: int, payload_cols: int, n_buckets: int):
    """Partition-first phase A body: generate chunk r and group its
    rows by destination bucket with ONE single-key sort.

    The bucket id (count of splitters <= key — identical segment
    semantics to _plan_splitters' side='left' searchsorted) is the only
    KEY operand; key planes and payloads ride as payload operands.
    Each key then pays ONE full comparison
    sort (in the bucket merge) instead of two — the round-4 VERDICT's
    partition-first experiment. Returns the bucket-grouped planes plus
    this run's (B-1,) segment boundaries."""
    idx = r * jnp.uint32(n_run) + jnp.arange(n_run, dtype=jnp.uint32)
    key = keygen_hash(idx, seed)
    vals = [_value_col(idx, j, seed) for j in range(payload_cols - 1)]
    bid = jnp.zeros(n_run, jnp.uint32)
    for b in range(n_buckets - 1):
        ge = ((key.hi > sp_hi[b])
              | ((key.hi == sp_hi[b]) & (key.lo >= sp_lo[b])))
        bid = bid + ge.astype(jnp.uint32)
    out = jax.lax.sort([bid, key.lo, key.hi, idx] + vals, num_keys=1,
                       is_stable=False)
    bounds = jnp.searchsorted(
        out[0], jnp.arange(1, n_buckets, dtype=jnp.uint32),
        side="left").astype(jnp.int32)
    return (out[1], out[2], out[3]) + tuple(out[4:]) + (bounds,)


@functools.partial(jax.jit, static_argnames=("n_buckets", "per_run"))
def _plan_splitters(run_los, run_his, n_buckets: int, per_run: int):
    """Phase B: global bucket splitters + per-run segment boundaries."""
    samples_lo, samples_hi = [], []
    for lo, hi in zip(run_los, run_his):
        n = lo.shape[0]
        stride = max(n // per_run, 1)
        sel = (jnp.arange(per_run) * stride) % n
        samples_lo.append(jnp.take(lo, sel))
        samples_hi.append(jnp.take(hi, sel))
    s_lo = jnp.concatenate(samples_lo)
    s_hi = jnp.concatenate(samples_hi)
    s_hi, s_lo = jax.lax.sort([s_hi, s_lo], num_keys=2, is_stable=False)
    total = s_lo.shape[0]
    q = (jnp.arange(1, n_buckets) * total) // n_buckets
    sp = U64(s_lo[q], s_hi[q])  # (B-1,) ascending splitters
    # segment boundary of splitter b in run r: first position >= splitter
    bounds = []
    for lo, hi in zip(run_los, run_his):
        bounds.append(searchsorted_u64(U64(lo, hi), sp, side="left"))
    return sp.lo, sp.hi, jnp.stack(bounds)  # (R, B-1)


def _merge_bucket_fn(n_runs: int, cap_seg: int, seed: int,
                     collect: bool = False, payload_cols: int = 1):
    """Build the jitted phase-C body for one bucket (static capacity).

    collect=True additionally returns the sorted bucket arrays (for
    small-n oracle tests ONLY — at 1B keeping every bucket's output
    alive through the pipelined dispatch loop would need ~15 GB)."""
    ncols = 2 + payload_cols      # key lo, key hi, index, value cols...

    @jax.jit
    def merge(starts, deltas, sizes, *run_arrays):
        # run_arrays = ncols per run: lo, hi, pay[, v1, v2, ...] ...
        # starts are pre-clamped host-side so start+cap_seg stays in
        # bounds (dynamic_slice CLAMPS out-of-bounds starts downward,
        # which would silently substitute earlier — duplicate — rows);
        # deltas locate the real segment inside the clamped window.
        segs = [[] for _ in range(ncols)]
        ar = jnp.arange(cap_seg, dtype=jnp.uint32)
        for r in range(n_runs):
            cols = run_arrays[ncols * r: ncols * (r + 1)]
            d = deltas[r].astype(jnp.uint32)
            in_seg = (ar >= d) & (ar < d + sizes[r].astype(jnp.uint32))
            for c in range(ncols):
                sl = jax.lax.dynamic_slice(cols[c], (starts[r],),
                                           (cap_seg,))
                fill = _ONES if c < 2 else jnp.uint32(0)
                segs[c].append(jnp.where(in_seg, sl, fill))
        lo, hi, pay = (jnp.concatenate(segs[0]), jnp.concatenate(segs[1]),
                       jnp.concatenate(segs[2]))
        vals = [jnp.concatenate(s) for s in segs[3:]]
        # sentinel pads sort after every real key; valid count masks them
        n_valid = jnp.sum(sizes).astype(jnp.uint32)
        sorted_all = jax.lax.sort([hi, lo, pay] + vals, num_keys=3,
                                  is_stable=False)
        shi, slo, spay = sorted_all[:3]
        svals = sorted_all[3:]
        # ---- on-device verification (full, not sampled) ----
        m = slo.shape[0]
        pos = jnp.arange(m, dtype=jnp.uint32)
        valid = pos < n_valid
        ge = ((shi[1:] > shi[:-1])
              | ((shi[1:] == shi[:-1]) & (slo[1:] >= slo[:-1])))
        sorted_ok = jnp.all(ge | ~valid[1:])
        want = keygen_hash(spay, seed)
        hash_ok = jnp.all((~valid) | ((slo == want.lo) & (shi == want.hi)))
        # carried value columns: every output row's values must still be
        # the generator's closed form of ITS OWN carried index — rows
        # (key, idx, v...) move as units or this fails
        for j, sv in enumerate(svals):
            hash_ok &= jnp.all((~valid)
                               | (sv == _value_col(spay, j, seed)))
        # u32 wraparound sums (exact mod 2^32; x64 stays off)
        pay_sum = jnp.sum(jnp.where(valid, spay, 0), dtype=jnp.uint32)
        pay_sq = jnp.sum(jnp.where(valid, spay * spay, 0),
                         dtype=jnp.uint32)
        first_lo, first_hi = slo[0], shi[0]
        li = jnp.maximum(n_valid, 1) - 1
        last_lo, last_hi = slo[li], shi[li]
        outs = (sorted_ok.astype(jnp.uint32), hash_ok.astype(jnp.uint32),
                n_valid, pay_sum, pay_sq,
                first_lo, first_hi, last_lo, last_hi)
        if collect:
            outs = outs + (slo, shi, spay) + tuple(svals)
        return outs

    return merge


# RunState moved to tpu_qe.utils.checkpoint (leaf module) so the
# out-of-core join/aggregate drivers can subclass it without import
# cycles through tpu_qe.ops; legacy name kept for tests/back-compat.
_RunState = RunState


@dataclasses.dataclass(frozen=True)
class BigSortResult:
    n: int
    seconds: float
    keys_per_s: float
    sorted_ok: bool
    hash_ok: bool
    count_ok: bool
    perm_ok: bool
    boundary_ok: bool
    phase_a_s: float
    phase_c_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return (self.sorted_ok and self.hash_ok and self.count_ok
                and self.perm_ok and self.boundary_ok)


@functools.partial(jax.jit, static_argnames=("n", "seed"))
def _incore_sort_and_verify(n: int, seed: int):
    """One resident program: generate -> sort -> verify, scalars out.

    Nothing but check scalars leaves the device, so XLA's planner can
    overlap/free buffers.
    """
    idx = jnp.arange(n, dtype=jnp.uint32)
    key = keygen_hash(idx, seed)
    shi, slo, spay = jax.lax.sort([key.hi, key.lo, idx], num_keys=3,
                                  is_stable=False)
    ge = ((shi[1:] > shi[:-1])
          | ((shi[1:] == shi[:-1]) & (slo[1:] >= slo[:-1])))
    sorted_ok = jnp.all(ge)
    want = keygen_hash(spay, seed)
    hash_ok = jnp.all((slo == want.lo) & (shi == want.hi))
    pay_sum = jnp.sum(spay, dtype=jnp.uint32)
    pay_sq = jnp.sum(spay * spay, dtype=jnp.uint32)
    return (sorted_ok.astype(jnp.uint32), hash_ok.astype(jnp.uint32),
            pay_sum, pay_sq)


def sort_big_incore(n: int, seed: int = 7) -> BigSortResult:
    """Single-program resident sort + full verification of n rows."""
    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    ex = _incore_sort_and_verify.lower(n=n, seed=seed).compile()
    compile_s = time.perf_counter() - tc0
    t0 = time.perf_counter()
    out = [np.asarray(x) for x in ex()]  # scalar readbacks fence
    dt = time.perf_counter() - t0
    s_ok, h_ok, psum, psq = out
    want_sum = np.uint32((n * (n - 1) // 2) & 0xFFFFFFFF)
    want_sq = np.uint32(((n - 1) * n * (2 * n - 1) // 6) & 0xFFFFFFFF)
    return BigSortResult(
        n=n, seconds=dt, keys_per_s=n / dt,
        sorted_ok=bool(s_ok), hash_ok=bool(h_ok), count_ok=True,
        perm_ok=bool((psum == want_sum) and (psq == want_sq)),
        boundary_ok=True, phase_a_s=0.0, phase_c_s=dt,
        compile_s=compile_s)


def sort_big(n: int, run_size: int = 1 << 26, n_buckets: int | None = None,
             seed: int = 7, samples_per_run: int = 4096,
             verbose: bool = False, collect: bool = False,
             checkpoint_dir: str | None = None, consume=None,
             payload_cols: int = 1, strategy: str = "partition"):
    """Device-resident out-of-core sort + full verification of n rows.

    n must be a multiple of run_size. Peak HBM ~ n*(8+4P) bytes for the
    resident runs plus one bucket's sort working set (~3x bucket bytes) —
    1B rows at P=1 is 12 GB of resident runs with run_size=64M.

    payload_cols: total u32 payload columns per row (>= 1). Column 1 is
    the unique global index; columns 2..P are carried value columns
    (table-shaped rows) — regenerable for verification but MOVED through
    every sort like real data, so their bandwidth cost is honest. Each
    output row's values are verified on device against its own carried
    index.

    consume: optional callable consume(b, bucket) invoked per bucket in
    GLOBAL KEY ORDER with DEVICE arrays (no host transfer): bucket =
    dict(key=U64 sorted keys, payload=u32 original row index, count=
    device scalar of valid rows); slots past count hold sentinel keys.
    Downstream on-device pipelines chain from here (the same stream
    contract as ops/bigjoin.py) — this is how sorted output larger than
    HBM leaves the engine without materializing.

    checkpoint_dir: persist the splitter plan and per-bucket completion
    state there (atomic npz, see _RunState) — a killed run resumes with
    phase A regenerated, phase B loaded, and completed buckets skipped
    (their verification scalars replay from the checkpoint), producing
    the identical verified result. collect=True (test-only) re-merges
    completed buckets to materialize their rows but still reuses the
    persisted plan.

    strategy: "partition" (default — the round-5 partition-first
    formulation: splitters from generated samples BEFORE any run, then
    each run pays ONE single-key bucket-id sort whose key/payload
    planes ride as ~free payload operands, and the bucket merge's full
    sort is the only comparison sort each key pays) or "merge" (the
    round-3 formulation: fully sort every run, then splitters from the
    sorted runs; each key pays two full sorts). Bit-identical verified
    output either way — the merge phase re-sorts its bucket from
    scratch in both. Which strategy is faster on a given device is an
    open measurement.
    """
    assert strategy in ("partition", "merge"), strategy
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 32), "payload travels as u32 global index"
    n_runs = n // run_size
    if n_buckets is None:
        # bucket working set ~3x its bytes; keep buckets <= 64M rows
        n_buckets = max(2, int(np.ceil(n / (1 << 26))))
    assert payload_cols >= 1, payload_cols
    meta = np.asarray([n, run_size, n_buckets, seed, samples_per_run,
                       payload_cols,
                       0 if strategy == "merge" else 1], dtype=np.int64)
    state = (RunState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)

    # Initialise the device and AOT-compile the phase-A executable
    # OUTSIDE the timed region (the measured rate is the compile-once
    # serving model — compile_s is reported).
    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])
    if strategy == "partition":
        plan0_exec = _plan_splitters_from_generator.lower(
            n_runs=n_runs, run_size=run_size, per_run=samples_per_run,
            n_buckets=n_buckets, seed=seed).compile()
        compile_s = time.perf_counter() - tc0
        # phase B0: splitters BEFORE any run exists (generated samples)
        t_b0 = time.perf_counter()
        sp_lo, sp_hi = plan0_exec()
        np.asarray(sp_lo[-1:])           # fence the plan
        t_b = time.perf_counter() - t_b0
        tcr = time.perf_counter()
        run_exec = _make_bucketed_run.lower(
            jnp.uint32(0), sp_lo, sp_hi, n_run=run_size, seed=seed,
            payload_cols=payload_cols, n_buckets=n_buckets).compile()
        compile_s += time.perf_counter() - tcr
    else:
        run_exec = _make_sorted_run.lower(
            jnp.uint32(0), n_run=run_size, seed=seed,
            payload_cols=payload_cols).compile()
        compile_s = time.perf_counter() - tc0

    from tpu_qe.utils.profiling import marker

    t0 = time.perf_counter()
    runs = []
    bound_devs = []
    with marker("bigsort phase A: run formation"):
        for r in range(n_runs):
            if strategy == "partition":
                out = run_exec(jnp.uint32(r), sp_lo, sp_hi)
                runs.append(out[:-1])
                bound_devs.append(out[-1])
            else:
                runs.append(run_exec(jnp.uint32(r)))
    # fence phase A (tiny readback per run tail)
    for run in runs:
        np.asarray(run[0][-1:])
    t_a = time.perf_counter() - t0

    # phase B: plan (AOT-compiled out of the timed region like the rest);
    # a resumed run MUST reuse the persisted plan — recomputing would be
    # deterministic today, but completed buckets are only meaningful
    # against the exact boundaries they were merged with.
    if state is not None:
        bounds = state.bounds
        if strategy != "partition":   # partition's plan already timed
            t_b = 0.0
    elif strategy == "partition":
        # boundaries came out of the bucketed runs themselves; their
        # readback rode the phase-A fence above
        bounds = np.stack([np.asarray(b) for b in bound_devs])
        if checkpoint_dir is not None:
            state = RunState.fresh(checkpoint_dir, meta, bounds, n_buckets)
    else:
        run_los = tuple(r[0] for r in runs)
        run_his = tuple(r[1] for r in runs)
        tcp = time.perf_counter()
        plan_exec = _plan_splitters.lower(run_los, run_his,
                                          n_buckets=n_buckets,
                                          per_run=samples_per_run).compile()
        compile_s += time.perf_counter() - tcp
        t_b0 = time.perf_counter()
        _, _, bounds = plan_exec(run_los, run_his)
        bounds = np.asarray(bounds)      # (R, B-1) readback fences phase B
        t_b = time.perf_counter() - t_b0
        if checkpoint_dir is not None:
            state = RunState.fresh(checkpoint_dir, meta, bounds, n_buckets)
    # per-(run, bucket) segment [start, end)
    zeros = np.zeros((n_runs, 1), dtype=bounds.dtype)
    full = np.full((n_runs, 1), run_size, dtype=bounds.dtype)
    starts = np.concatenate([zeros, bounds], axis=1)      # (R, B)
    ends = np.concatenate([bounds, full], axis=1)
    sizes = (ends - starts).astype(np.int32)
    # round the static segment capacity up to a 1M multiple: enough to
    # amortize recompiles across similar datasets without the up-to-2x
    # sort padding a power-of-two rounding costs (measured: pow2 rounding
    # turned a 33.5M demand into 64M and doubled every merge sort)
    quantum = 1 << 20 if run_size >= (1 << 22) else 256
    cap_seg = -(-max(int(sizes.max()), 1) // quantum) * quantum
    # a segment is a subrange of one run: never request a slice larger
    # than the run array (dynamic_slice would be a compile-time error)
    cap_seg = min(cap_seg, run_size)
    if verbose:
        print(f"bigsort: {n_runs} runs x {run_size}, {n_buckets} buckets, "
              f"cap_seg={cap_seg} (max demand {int(sizes.max())})")

    emit = collect or consume is not None
    merge = _merge_bucket_fn(n_runs, cap_seg, seed, collect=emit,
                             payload_cols=payload_cols)
    flat_runs = [a for r in runs for a in r]
    tc1 = time.perf_counter()
    ex_st = jnp.zeros(n_runs, jnp.int32)
    ex_sz = jnp.zeros(n_runs, jnp.int32)
    merge_exec = merge.lower(ex_st, ex_st, ex_sz, *flat_runs).compile()
    merge_compile_s = time.perf_counter() - tc1
    compile_s += merge_compile_s

    t1 = time.perf_counter()
    # completed buckets (from a resumed checkpoint) replay their recorded
    # scalars; with collect=True they still re-merge to materialize rows
    scal = np.zeros((n_buckets, RunState.N_SCALARS), np.int64)
    skip = set()
    if state is not None and not emit:
        for b in range(n_buckets):
            if state.done[b]:
                scal[b] = state.scalars[b]
                skip.add(b)
        if verbose and skip:
            print(f"bigsort: resuming — {len(skip)}/{n_buckets} buckets "
                  "already merged")
    # launch ALL pending bucket merges before reading any scalar back:
    # the device queues them and per-call dispatch round trips stop
    # serializing the merge phase; the scalar readbacks below end it.
    pending = {}
    for b in range(n_buckets):
        if b in skip:
            continue
        raw = starts[:, b].astype(np.int64)
        clamped = np.minimum(raw, max(run_size - cap_seg, 0))
        deltas = (raw - clamped).astype(np.int32)
        st = jnp.asarray(clamped.astype(np.int32))
        dl = jnp.asarray(deltas)
        sz = jnp.asarray(sizes[:, b].astype(np.int32))
        out = merge_exec(st, dl, sz, *flat_runs)
        if emit:
            out, bucket_arrays = out[:9], out[9:]
            if consume is not None:
                # hand the emitted arrays over AT DISPATCH TIME and drop
                # our reference: only the consumer's queued programs keep
                # them alive, so the device frees each bucket's stream as
                # soon as its consumer executes — peak HBM stays runs +
                # O(1) in-flight buckets, not runs + ALL emitted buckets
                slo, shi, spay = bucket_arrays[:3]
                consume(b, dict(key=U64(slo, shi), payload=spay,
                                values=tuple(bucket_arrays[3:]),
                                count=out[2]))
            pending[b] = (out, bucket_arrays if collect else None)
        else:
            pending[b] = (out, None)
    collected = []
    for b, (out, bucket_arrays) in pending.items():
        if collect:
            cnt_b = int(np.asarray(out[2]))
            collected.append(tuple(
                np.asarray(a)[:cnt_b] for a in bucket_arrays))
        vals = [np.asarray(x) for x in out]    # scalar readbacks fence
        scal[b] = [int(v) for v in vals]
        if state is not None:
            state.record(b, vals)
        if verbose:
            print(f"  bucket {b}: {scal[b, 2]} rows "
                  f"sorted={bool(scal[b, 0])} hash={bool(scal[b, 1])}")

    total_count = 0
    sum_pay = np.uint32(0)
    sum_sq = np.uint32(0)
    all_sorted = True
    all_hash = True
    boundary_ok = True
    prev_last = None
    for b in range(n_buckets):
        s_ok, h_ok, cnt, psum, psq, flo, fhi, llo, lhi = scal[b]
        all_sorted &= bool(s_ok)
        all_hash &= bool(h_ok)
        total_count += int(cnt)
        sum_pay = np.uint32((int(sum_pay) + int(psum)) & 0xFFFFFFFF)
        sum_sq = np.uint32((int(sum_sq) + int(psq)) & 0xFFFFFFFF)
        if prev_last is not None and cnt > 0:
            pl_lo, pl_hi = prev_last
            le = (pl_hi < fhi or (pl_hi == fhi and pl_lo <= flo))
            boundary_ok &= bool(le)  # numpy bool_ would poison JSON out
        if cnt > 0:
            prev_last = (llo, lhi)
    t_c = time.perf_counter() - t1

    # permutation evidence: payload sum / sum of squares over all buckets
    # must equal sum over 0..n-1 (mod 2^32) — with count and per-row hash
    # validity this pins the output to a permutation of the input stream.
    # (closed forms via Python bigints: no 8 GB host array needed)
    want_sum = np.uint32((n * (n - 1) // 2) & 0xFFFFFFFF)
    want_sq = np.uint32(((n - 1) * n * (2 * n - 1) // 6) & 0xFFFFFFFF)
    perm_ok = (sum_pay == want_sum) and (sum_sq == want_sq)
    count_ok = total_count == n
    # total = runs + plan + merges; mid-stream compiles are excluded
    # (reported in compile_s)
    dt = t_a + t_b + t_c
    res = BigSortResult(
        n=n, seconds=dt, keys_per_s=n / dt,
        sorted_ok=all_sorted, hash_ok=all_hash, count_ok=count_ok,
        perm_ok=bool(perm_ok), boundary_ok=boundary_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if collect:
        lo = np.concatenate([c[0] for c in collected])
        hi = np.concatenate([c[1] for c in collected])
        pay = np.concatenate([c[2] for c in collected])
        keys = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
        if payload_cols > 1:
            vals = tuple(np.concatenate([c[3 + j] for c in collected])
                         for j in range(payload_cols - 1))
            return res, (keys, pay, vals)
        return res, (keys, pay)
    return res
