"""Distributed out-of-core sort: data larger than ONE device's sortable set.

Composes the two scaling axes that previously never met (the last
SURVEY-mandated composition):

  - sort/bigsort.py scales past a single lax.sort program on ONE chip
    (external sample sort: sorted runs + splitter plan + bucket merges);
  - exchange/dsort.py scales across a device MESH (splitter shuffle) but
    holds each shard as one resident lax.sort.

Here the aggregate dataset exceeds what any one device can sort in a
single program, so BOTH are needed: every device forms R sorted runs of
its local rows (phase A), one global splitter plan partitions the key
space into D*B buckets (phase B), a per-run segment all_to_all moves each
run's contiguous per-destination slices to their owner device (phase X —
the cross-device bucket exchange), and each device merges its B local
buckets exactly like bigsort phase C (phase C), verifying everything on
device. Only plan integers and check scalars cross the host boundary.

Design notes:

  * The exchange moves SEGMENTS, not rows: runs are sorted, so the rows a
    run sends to device t form one contiguous slice [pos[t*B], pos[(t+1)*B])
    — a dynamic_slice per (run, dest) plus one lax.all_to_all of a
    (D, cap_blk) block per column. No per-row routing, no one-hot
    histograms: the phase-B boundaries ARE the exact per-pair counts, so
    capacities are demand-sized with zero sampling error
    (plan-then-execute, stronger than the row-shuffle's oversampled plan).
  * Static shapes everywhere: block and segment capacities are the exact
    measured max demand rounded to a quantum (bounded recompiles), with
    host-side start clamping + delta masks (dynamic_slice clamps
    out-of-bounds starts DOWNWARD — pre-clamp and mask, CLAUDE.md).
  * Memory: peak per device ~ n_local * 12 B (runs) + one run's exchange
    blocks in flight — run r's arrays are dropped as soon as its exchange
    is dispatched, so runs and received blocks never both exist in full.
  * Skew: bucket capacities are sized to exact demand, so heavy keys
    cannot overflow — they only imbalance bucket sizes (same contract as
    single-chip bigsort). The row-level distributed_sort's (key, position)
    splitters remain the tool when per-device balance under adversarial
    duplicates matters more than out-of-core capacity.

Reference contrast: the reference's only communication is one wgpu queue
submit (/root/reference/src/main.rs:727); this module is the mandated
scaled sorted-key-stream — SURVEY.md §2c communication-backend row and
§5 "long-context analogue" — at data sizes no single device can hold.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_qe.bits import U64
from tpu_qe.exchange.shuffle import AXIS
from tpu_qe.ops.join import searchsorted_u64
from tpu_qe.sort.bigsort import BigSortResult, keygen_hash

_ONES = jnp.uint32(0xFFFFFFFF)


def _keygen_masked(idx, seed: int, key_bits: int):
    """keygen_hash with keys narrowed to key_bits (duplicate/skew tests).

    key_bits < 64 collapses the key space to 2^key_bits distinct values —
    the adversarial-duplicates regime for a splitter-partitioned sort
    (a hot key's whole run lands in one bucket). The verification
    property is preserved: output key == _keygen_masked(payload).
    """
    k = keygen_hash(idx, seed)
    if key_bits >= 64:
        return k
    if key_bits <= 32:
        m = jnp.uint32((1 << key_bits) - 1)
        return U64(k.lo & m, jnp.zeros_like(k.hi))
    m = jnp.uint32((1 << (key_bits - 32)) - 1)
    return U64(k.lo, k.hi & m)


def keygen_masked_numpy(idx: np.ndarray, seed: int = 7,
                        key_bits: int = 64) -> np.ndarray:
    """Numpy mirror of _keygen_masked (for oracle checks in tests)."""
    from tpu_qe.sort.bigsort import keygen_hash_numpy
    k = keygen_hash_numpy(idx, seed)
    if key_bits >= 64:
        return k
    return k & np.uint64((1 << key_bits) - 1)


# ----------------------------------------------------------------- phase A

def _runner_fn(mesh: Mesh, n_local: int, run_size: int, seed: int,
               key_bits: int, payload_cols: int = 1):
    """Jitted program forming run r on every device simultaneously.

    payload_cols > 1 appends carried value columns (the single-chip
    sort_big contract — table-shaped rows through the whole exchange)."""
    from tpu_qe.sort.bigsort import _value_col

    def body(r):
        d = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        base = d * jnp.uint32(n_local) + r * jnp.uint32(run_size)
        idx = base + jnp.arange(run_size, dtype=jnp.uint32)
        key = _keygen_masked(idx, seed, key_bits)
        vals = [_value_col(idx, j, seed) for j in range(payload_cols - 1)]
        out = jax.lax.sort([key.hi, key.lo, idx] + vals, num_keys=3,
                           is_stable=False)
        return (out[1], out[0], out[2]) + tuple(out[3:])

    ncols = 2 + payload_cols
    fn = shard_map(body, mesh=mesh, in_specs=(P(),),
                   out_specs=tuple([P(AXIS)] * ncols), check_vma=False)
    return jax.jit(fn)


# ----------------------------------------------------------------- phase B

def _planner_fn(mesh: Mesh, n_runs: int, n_buckets_total: int,
                per_run: int, run_size: int):
    """Global splitters at the (D*B)-quantiles + per-run boundaries.

    Samples are strided picks from each SORTED run (i.e. per-run
    quantiles), all_gathered and sorted globally; boundaries are exact
    searchsorted positions, so downstream capacities carry no sampling
    error — only imbalance does.
    """

    def body(*run_cols):
        # run_cols = lo0, hi0, lo1, hi1, ...
        stride = max(run_size // per_run, 1)
        sel = (jnp.arange(per_run) * stride) % run_size
        s_lo = jnp.concatenate(
            [jnp.take(run_cols[2 * r], sel) for r in range(n_runs)])
        s_hi = jnp.concatenate(
            [jnp.take(run_cols[2 * r + 1], sel) for r in range(n_runs)])
        g_lo = jax.lax.all_gather(s_lo, AXIS).reshape(-1)
        g_hi = jax.lax.all_gather(s_hi, AXIS).reshape(-1)
        g_hi, g_lo = jax.lax.sort([g_hi, g_lo], num_keys=2, is_stable=False)
        total = g_lo.shape[0]
        q = (jnp.arange(1, n_buckets_total) * total) // n_buckets_total
        sp = U64(g_lo[q], g_hi[q])           # (S-1,) global splitters
        bounds = jnp.stack([
            searchsorted_u64(
                U64(run_cols[2 * r], run_cols[2 * r + 1]), sp, side="left")
            for r in range(n_runs)])          # (R, S-1) per device
        return sp.lo, sp.hi, bounds

    specs = tuple([P(AXIS)] * (2 * n_runs))
    fn = shard_map(body, mesh=mesh, in_specs=specs,
                   out_specs=(P(), P(), P(AXIS, None)), check_vma=False)
    return jax.jit(fn)


# ----------------------------------------------------------------- phase X

def _exchange_fn(mesh: Mesh, n_dev: int, cap_blk: int, cap_off: int,
                 fills=None):
    """Per-run segment exchange: device s sends run-slice t to device t.

    Column-generic: `fills` gives the sentinel per exchanged column
    (default: the sort's (key lo, key hi, payload) triple). ops/dbigjoin
    reuses this with 3-column left and 2-column right layouts.

    Two-tier (diagonal-bypass, same model as exchange/shuffle.py): only
    OFF-diagonal segments enter the all_to_all, at `cap_off` sized to the
    off-diagonal demand; each device's own (diagonal) share is patched
    into its row of the received block with one local dynamic_update_slice
    — zero interconnect for the 1/D stay-local share, and a skewed local
    share (pre-partitioned data) no longer inflates the exchange buffers.
    With D == 1 the collective disappears entirely.

    starts/deltas/sizes are per-device (D,) plans (host-computed from the
    exact phase-B boundaries; starts_d/deltas_d re-clamped for the wider
    diagonal window). Output blocks: per device, (D, cap_blk) per column —
    row s holds the segment received from source s, with sentinel keys /
    zero payloads outside [delta, delta+size).
    """

    if fills is None:
        fills = (_ONES, _ONES, jnp.uint32(0))

    def body(starts, deltas, sizes, starts_d, deltas_d, *cols):
        # plans arrive per-shard as (1, D) slices of the (D, D) host plan
        starts = starts.reshape(-1)
        deltas = deltas.reshape(-1)
        sizes = sizes.reshape(-1)
        starts_d = starts_d.reshape(-1)
        deltas_d = deltas_d.reshape(-1)
        me = jax.lax.axis_index(AXIS)
        ar_off = jnp.arange(cap_off, dtype=jnp.uint32)
        ar_blk = jnp.arange(cap_blk, dtype=jnp.uint32)

        def blocks(col, fill):
            if n_dev > 1:
                outs = []
                for t in range(n_dev):
                    sl = jax.lax.dynamic_slice(col, (starts[t],),
                                               (cap_off,))
                    d = deltas[t].astype(jnp.uint32)
                    in_seg = (ar_off >= d) & (
                        ar_off < d + sizes[t].astype(jnp.uint32))
                    outs.append(jnp.where(in_seg, sl, fill))
                x = jnp.stack(outs)                      # (D, cap_off)
                y = jax.lax.all_to_all(x, AXIS, 0, 0)    # row s <- src s
                y = jnp.pad(y, ((0, 0), (0, cap_blk - cap_off)),
                            constant_values=fill)
            else:
                y = jnp.full((1, cap_blk), fill, col.dtype)
            # patch own row with the local (diagonal) share
            st = jnp.take(starts_d, me)
            dl = jnp.take(deltas_d, me).astype(jnp.uint32)
            sz = jnp.take(sizes, me).astype(jnp.uint32)
            sl = jax.lax.dynamic_slice(col, (st,), (cap_blk,))
            sl = jnp.where((ar_blk >= dl) & (ar_blk < dl + sz), sl, fill)
            return jax.lax.dynamic_update_slice(
                y, sl[None, :], (me.astype(jnp.int32), jnp.int32(0)))

        return tuple(blocks(c, fills[i]) for i, c in enumerate(cols))

    plan = P(AXIS, None)
    nc = len(fills)
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(plan,) * 5 + (P(AXIS),) * nc,
        out_specs=(plan,) * nc, check_vma=False)
    return jax.jit(fn)


# ----------------------------------------------------------------- phase C

def _merger_fn(mesh: Mesh, n_runs: int, n_dev: int, cap_blk: int,
               cap_seg: int, seed: int, key_bits: int, collect: bool,
               payload_cols: int = 1):
    """Per-bucket merge + full on-device verification, all devices at once.

    Each device slices, from every (run, source) block, its current
    bucket's sub-segment, sentinel-masks, sorts the concatenation, and
    verifies: full sortedness, per-row key == keygen_hash(payload), exact
    count, payload sum / sum-of-squares (permutation evidence), first and
    last keys (cross-bucket boundary order, checked on host).
    """
    m = n_runs * n_dev * cap_seg
    ncols = 2 + payload_cols
    from tpu_qe.sort.bigsort import _value_col

    def body(starts, deltas, sizes, *block_cols):
        # starts/deltas/sizes: (R, D) per device; block_cols: R groups of
        # ncols (D, cap_blk) arrays (lo, hi, pay[, v...] per run).
        ar = jnp.arange(cap_seg, dtype=jnp.uint32)
        segs = [[] for _ in range(ncols)]
        for r in range(n_runs):
            cols = block_cols[ncols * r: ncols * (r + 1)]
            for sdev in range(n_dev):
                st = starts[r, sdev]
                d = deltas[r, sdev].astype(jnp.uint32)
                sz = sizes[r, sdev].astype(jnp.uint32)
                in_seg = (ar >= d) & (ar < d + sz)
                si = jnp.int32(sdev)
                for c in range(ncols):
                    sl = jax.lax.dynamic_slice(cols[c], (si, st),
                                               (1, cap_seg))[0]
                    fill = _ONES if c < 2 else jnp.uint32(0)
                    segs[c].append(jnp.where(in_seg, sl, fill))
        lo = jnp.concatenate(segs[0])
        hi = jnp.concatenate(segs[1])
        pay = jnp.concatenate(segs[2])
        vals = [jnp.concatenate(x) for x in segs[3:]]
        n_valid = jnp.sum(sizes).astype(jnp.uint32)
        sorted_all = jax.lax.sort([hi, lo, pay] + vals, num_keys=3,
                                  is_stable=False)
        shi, slo, spay = sorted_all[:3]
        svals = sorted_all[3:]
        pos = jnp.arange(m, dtype=jnp.uint32)
        valid = pos < n_valid
        ge = ((shi[1:] > shi[:-1])
              | ((shi[1:] == shi[:-1]) & (slo[1:] >= slo[:-1])))
        sorted_ok = jnp.all(ge | ~valid[1:])
        want = _keygen_masked(spay, seed, key_bits)
        hash_ok = jnp.all((~valid) | ((slo == want.lo) & (shi == want.hi)))
        for j, sv in enumerate(svals):
            hash_ok &= jnp.all((~valid)
                               | (sv == _value_col(spay, j, seed)))
        pay_sum = jnp.sum(jnp.where(valid, spay, 0), dtype=jnp.uint32)
        pay_sq = jnp.sum(jnp.where(valid, spay * spay, 0), dtype=jnp.uint32)
        first_lo, first_hi = slo[0], shi[0]
        li = jnp.maximum(n_valid, 1) - 1
        last_lo, last_hi = slo[li], shi[li]
        outs = tuple(x.reshape(1) for x in (
            sorted_ok.astype(jnp.uint32), hash_ok.astype(jnp.uint32),
            n_valid, pay_sum, pay_sq, first_lo, first_hi, last_lo, last_hi))
        if collect:
            outs = outs + (slo, shi, spay) + tuple(svals)
        return outs

    plan = P(AXIS, None)
    n_scalar = 9
    out_specs = tuple(
        [P(AXIS)] * (n_scalar + (ncols if collect else 0)))
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(plan, plan, plan) + tuple([plan] * (ncols * n_runs)),
        out_specs=out_specs, check_vma=False)
    return jax.jit(fn)


def _quantize(demand: int, quantum: int, ceiling: int) -> int:
    return min(-(-max(demand, 1) // quantum) * quantum, ceiling)


def sort_big_distributed(n: int, mesh: Mesh, run_size: int = 1 << 26,
                         buckets_per_dev: int | None = None, seed: int = 7,
                         samples_per_run: int = 4096, key_bits: int = 64,
                         verbose: bool = False, collect: bool = False,
                         checkpoint_dir: str | None = None,
                         force_composed: bool = False,
                         payload_cols: int = 1):
    """Distributed + out-of-core sort of n generated rows over `mesh`.

    n must be divisible by D * run_size (D = mesh size). Rows are
    generated on device from the regenerable index hash (bigsort's
    keygen_hash: key == hash(global index) — the property every output
    row is re-verified against on device). Device d's output, bucket by
    bucket, is the d-th quantile range of the global sorted order.

    With D == 1 the exchange has nothing to move, so the call DELEGATES
    to single-device sort_big (same data model, same verification).
    force_composed=True keeps the composed machinery at
    D=1 (identity all_to_all + block copies) — tests and machinery
    measurements; multi-device runs are validated on the CPU mesh
    (tests) and the dryrun gate.

    Returns BigSortResult (wall time covers phases A+B+X+C; compiles are
    AOT, outside the timed region). With collect=True additionally
    returns (keys, payload) assembled on host in global order — small-n
    oracle tests only.

    checkpoint_dir: same resume contract as sort_big — the splitter plan
    and per-bucket completion scalars persist (phases A and X regenerate
    deterministically); completed bucket-merge rounds skip and replay
    their recorded per-device scalars. collect=True re-merges but reuses
    the persisted plan.
    """
    n_dev = int(mesh.shape[AXIS])
    if n_dev == 1 and key_bits == 64 and not force_composed:
        from tpu_qe.sort.bigsort import sort_big
        return sort_big(n, run_size=run_size, n_buckets=buckets_per_dev,
                        seed=seed, samples_per_run=samples_per_run,
                        verbose=verbose, collect=collect,
                        checkpoint_dir=checkpoint_dir,
                        payload_cols=payload_cols)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 32), "payload travels as u32 global index"
    n_local = n // n_dev
    n_runs = n_local // run_size
    if buckets_per_dev is None:
        buckets_per_dev = max(1, int(np.ceil(n_local / (1 << 26))))
    n_b = buckets_per_dev
    S = n_dev * n_b
    per_run = min(samples_per_run, run_size)
    quantum = 1 << 20 if run_size >= (1 << 22) else 256
    from tpu_qe.sort.bigsort import _RunState
    n_scal = 9
    assert payload_cols >= 1, payload_cols
    ncols = 2 + payload_cols
    meta = np.asarray([n, n_dev, run_size, n_b, seed, per_run,
                       key_bits, payload_cols], dtype=np.int64)
    state = (_RunState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)

    # explicit shardings for host-built inputs: AOT executables pin input
    # shardings at lower time, so every call must match exactly
    rep = NamedSharding(mesh, P())
    plan_sh = NamedSharding(mesh, P(AXIS, None))

    def _rep(x):
        return jax.device_put(x, rep)

    def _plan_put(x):
        return jax.device_put(jnp.asarray(x, jnp.int32), plan_sh)

    # ---- AOT compiles (outside the timed region, like bigsort) ----
    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    runner = _runner_fn(mesh, n_local, run_size, seed, key_bits,
                        payload_cols=payload_cols)
    run_exec = runner.lower(_rep(jnp.uint32(0))).compile()
    compile_s = time.perf_counter() - tc0

    # ---- phase A: per-device sorted runs ----
    t0 = time.perf_counter()
    runs = []
    for r in range(n_runs):
        runs.append(run_exec(_rep(jnp.uint32(r))))
    for run in runs:
        np.asarray(jax.device_get(run[0][-1:]))  # fence
    t_a = time.perf_counter() - t0

    # ---- phase B: global splitters + exact per-run boundaries (a
    # resumed run reuses the persisted plan, see sort_big) ----
    if state is not None:
        bounds = state.bounds.reshape(n_dev, n_runs, S - 1)
        t_b = 0.0
    else:
        tcp = time.perf_counter()
        planner = _planner_fn(mesh, n_runs, S, per_run, run_size)
        flat_keys = tuple(a for run in runs for a in run[:2])
        plan_exec = planner.lower(*flat_keys).compile()
        compile_s += time.perf_counter() - tcp
        t_b0 = time.perf_counter()
        _, _, bounds = plan_exec(*flat_keys)
        bounds = np.asarray(bounds).reshape(n_dev, n_runs, S - 1)
        t_b = time.perf_counter() - t_b0
        if checkpoint_dir is not None:
            state = _RunState.fresh(checkpoint_dir, meta, bounds, n_b,
                                    n_scalars=n_dev * n_scal)
    # pos[d, r, g] for g in 0..S inclusive
    zeros = np.zeros((n_dev, n_runs, 1), dtype=np.int64)
    full = np.full((n_dev, n_runs, 1), run_size, dtype=np.int64)
    pos = np.concatenate([zeros, bounds.astype(np.int64), full], axis=2)

    # per-(src d, run r, dest t) block = [pos[d,r,t*B], pos[d,r,(t+1)*B])
    blk_start = pos[:, :, 0:S + 1:n_b][:, :, :-1]        # (D, R, D)
    blk_end = pos[:, :, 0:S + 1:n_b][:, :, 1:]
    blk_size = blk_end - blk_start
    cap_blk = _quantize(int(blk_size.max()), quantum, run_size)
    # two-tier capacities: only OFF-diagonal (src != dest) blocks enter
    # the all_to_all; the stay-local diagonal share is patched in locally
    # at full cap_blk width (see _exchange_fn)
    eye = np.eye(n_dev, dtype=bool)[:, None, :]          # (D, 1, D)
    off_max = int(np.where(eye, 0, blk_size).max()) if n_dev > 1 else 0
    cap_off = _quantize(off_max, quantum, cap_blk) if n_dev > 1 else 16
    # per-(src d, run r, global bucket g) segment, relative to its block
    seg_size = pos[:, :, 1:] - pos[:, :, :-1]            # (D, R, S)
    cap_seg = _quantize(int(seg_size.max()), quantum, cap_blk)
    if verbose:
        print(f"dbigsort: D={n_dev} R={n_runs} B={n_b} run={run_size} "
              f"cap_blk={cap_blk} (max {int(blk_size.max())}) "
              f"cap_off={cap_off} (max {off_max}) "
              f"cap_seg={cap_seg} (max {int(seg_size.max())})")

    # ---- phase X: per-run segment exchange ----
    tcx = time.perf_counter()
    fills = (_ONES, _ONES) + tuple(jnp.uint32(0)
                                   for _ in range(payload_cols))
    exchanger = _exchange_fn(mesh, n_dev, cap_blk, cap_off,
                             fills=fills)
    iplan = _plan_put(np.zeros((n_dev, n_dev), np.int32))
    ex_exec = exchanger.lower(iplan, iplan, iplan, iplan, iplan,
                              *runs[0]).compile()
    compile_s += time.perf_counter() - tcx
    t_x0 = time.perf_counter()
    blocks = []
    off_ceiling = max(run_size - cap_off, 0)
    diag_ceiling = max(run_size - cap_blk, 0)
    for r in range(n_runs):
        raw = blk_start[:, r, :]                          # (D, D)
        clamped = np.minimum(raw, off_ceiling)
        st = _plan_put(clamped)
        dl = _plan_put(raw - clamped)
        sz = _plan_put(blk_size[:, r, :])
        clamped_d = np.minimum(raw, diag_ceiling)
        st_d = _plan_put(clamped_d)
        dl_d = _plan_put(raw - clamped_d)
        blocks.append(ex_exec(st, dl, sz, st_d, dl_d, *runs[r]))
        runs[r] = None  # free run r once its exchange is dispatched
    del runs
    for blk in blocks:
        np.asarray(jax.device_get(blk[0][-1:, -1:]))  # fence
    t_x = time.perf_counter() - t_x0

    # ---- phase C: per-bucket merges (all devices in parallel) ----
    # within-block segment start of global bucket g = t*B + b for source
    # (d, r): delta_of_block + (pos[g] - pos[t*B]); host pre-clamps for
    # the cap_seg dynamic_slice window.
    tcm = time.perf_counter()
    merger = _merger_fn(mesh, n_runs, n_dev, cap_blk, cap_seg, seed,
                        key_bits, collect, payload_cols=payload_cols)
    mplan = _plan_put(np.zeros((n_dev * n_runs, n_dev), np.int32))
    flat_blocks = [a for blk in blocks for a in blk]
    merge_exec = merger.lower(mplan, mplan, mplan, *flat_blocks).compile()
    compile_s += time.perf_counter() - tcm

    t_c0 = time.perf_counter()
    # per-entry clamp ceiling mirrors the exchange's two-tier packing:
    # diagonal (src == dest) blocks were placed with the cap_blk window,
    # off-diagonal ones with the cap_off window
    ceil_mat = np.where(eye, diag_ceiling, off_ceiling)   # (D, 1, D)
    blk_clamped = np.minimum(blk_start, ceil_mat)         # (D, R, D)
    blk_delta = blk_start - blk_clamped
    seg_ceiling = max(cap_blk - cap_seg, 0)
    scal = np.zeros((n_b, n_dev, n_scal), np.int64)
    skip = set()
    if state is not None and not collect:
        for b in range(n_b):
            if state.done[b]:
                scal[b] = state.scalars[b].reshape(n_dev, n_scal)
                skip.add(b)
        if verbose and skip:
            print(f"dbigsort: resuming — {len(skip)}/{n_b} bucket rounds "
                  "already merged")
    pending = {}
    for b in range(n_b):
        if b in skip:
            continue
        # device t's bucket b is global bucket g = t*B + b; plan arrays
        # indexed [t][r, s] = segment of (src s, run r) inside block
        # (s, r, t).
        g = np.arange(n_dev) * n_b + b                    # (D,) per dest t
        # ws[t, s, r] = blk_delta[s, r, t] + pos[s, r, g[t]] - blk_start[s, r, t]
        ws = (blk_delta.transpose(2, 0, 1)                # (t, s, r)
              + pos[:, :, :-1].transpose(0, 2, 1)[
                  np.arange(n_dev)[None, :], g[:, None], :].transpose(0, 1, 2)
              - blk_start.transpose(2, 0, 1))
        zs = seg_size.transpose(0, 2, 1)[
            np.arange(n_dev)[None, :], g[:, None], :]     # (t, s, r)
        ws_c = np.minimum(ws, seg_ceiling)
        dl = ws - ws_c
        # reorder to (t, r, s) then flatten to (D*R, D) sharded plans
        def _plan(x):
            return _plan_put(
                x.transpose(0, 2, 1).reshape(n_dev * n_runs, n_dev))
        pending[b] = merge_exec(_plan(ws_c), _plan(dl), _plan(zs),
                                *flat_blocks)

    collected = {}
    for b, out in pending.items():
        if collect:
            out, bucket_arrays = out[:9], out[9:]
        vals = [np.asarray(x) for x in out]   # (D,) each; readback fences
        scal[b] = np.stack(vals, axis=1)      # (D, 9)
        if state is not None:
            state.record(b, scal[b].reshape(-1))
        if collect:
            ba = [np.asarray(a).reshape(n_dev, -1) for a in bucket_arrays]
            for t in range(n_dev):
                c = int(vals[2][t])
                collected[t * n_b + b] = tuple(a[t, :c] for a in ba)
        if verbose:
            print(f"  bucket {b}: counts={vals[2].tolist()} "
                  f"sorted={bool(vals[0].all())} hash={bool(vals[1].all())}")

    total_count = 0
    sum_pay = 0
    sum_sq = 0
    all_sorted = True
    all_hash = True
    boundary_ok = True
    firsts = {}
    lasts = {}
    counts = np.zeros((n_dev, n_b), np.int64)
    for b in range(n_b):
        s_ok, h_ok, cnt, psum, psq, flo, fhi, llo, lhi = scal[b].T
        all_sorted &= bool(s_ok.all())
        all_hash &= bool(h_ok.all())
        total_count += int(cnt.sum())
        sum_pay = (sum_pay + int(psum.sum())) & 0xFFFFFFFF
        sum_sq = (sum_sq + int(psq.sum())) & 0xFFFFFFFF
        counts[:, b] = cnt
        for t in range(n_dev):
            g = t * n_b + b
            firsts[g] = (int(flo[t]), int(fhi[t]))
            lasts[g] = (int(llo[t]), int(lhi[t]))
    t_c = time.perf_counter() - t_c0

    # cross-bucket boundary order in GLOBAL bucket order g = t*B + b
    prev_last = None
    for g in range(S):
        if counts.reshape(-1)[g] == 0:  # counts[t, b], g = t*B + b
            continue
        if prev_last is not None:
            pl_lo, pl_hi = prev_last
            f_lo, f_hi = firsts[g]
            le = (pl_hi < f_hi) or (pl_hi == f_hi and pl_lo <= f_lo)
            boundary_ok &= le
        prev_last = lasts[g]

    want_sum = (n * (n - 1) // 2) & 0xFFFFFFFF
    want_sq = ((n - 1) * n * (2 * n - 1) // 6) & 0xFFFFFFFF
    dt = t_a + t_b + t_x + t_c
    res = BigSortResult(
        n=n, seconds=dt, keys_per_s=n / dt,
        sorted_ok=all_sorted, hash_ok=all_hash,
        count_ok=(total_count == n),
        perm_ok=bool((sum_pay == want_sum) and (sum_sq == want_sq)),
        boundary_ok=boundary_ok,
        phase_a_s=t_a, phase_c_s=t_c, compile_s=compile_s)
    if verbose:
        print(f"dbigsort phases: A={t_a:.2f}s B={t_b:.2f}s X={t_x:.2f}s "
              f"C={t_c:.2f}s total={dt:.2f}s")
    if collect:
        lo = np.concatenate([collected[g][0] for g in range(S)])
        hi = np.concatenate([collected[g][1] for g in range(S)])
        pay = np.concatenate([collected[g][2] for g in range(S)])
        keys = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
        if payload_cols > 1:
            vals = tuple(
                np.concatenate([collected[g][3 + j] for g in range(S)])
                for j in range(payload_cols - 1))
            return res, (keys, pay, vals)
        return res, (keys, pay)
    return res
