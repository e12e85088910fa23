"""Distributed out-of-core FK join: both sides larger than any device.

The final cell of the engine's composition matrix — the join analogue of
sort/dbigsort.py, built from the same verified pieces:

  phase A   per device, per side: sorted runs of the LOCAL share of each
            side (left rows carry their global index as payload; right
            rows need none — the joined value is a closed form of the
            key, ops/bigjoin.py's data model). Generation is on-device
            from the regenerable global index (no host streaming, see
            sort/bigsort.py).
  phase B   ONE splitter plan over the UNION of both key distributions
            (per-run quantile samples from both sides, all_gathered);
            per-run bucket boundaries are exact searchsorted positions —
            capacities carry no sampling error (plan-then-execute). All
            duplicates of a key land in one bucket on BOTH sides, so
            per-bucket joins compose exactly.
  phase X   per-run segment all_to_all for each side (the column-generic
            dbigsort exchange: contiguous slices, diagonal bypass, no
            row-level routing) — device t receives every run's bucket
            range [t*B, (t+1)*B) of both sides.
  phase C   per device, per local bucket: slice the bucket's
            sub-segments from every (run, source) block of both sides,
            mask, and run the in-core scan join (ops/join.py
            join_fk_scan with validity masks) + the construction-exact
            on-device verification of ops/bigjoin.py (every left row's
            match flag and joined value, exact counts).

Only plan integers and check scalars cross the host boundary. With
D == 1 this degenerates to ops/bigjoin.py through identity exchanges —
the measurable path on the one real chip; multi-device runs are
validated on the CPU mesh bit-exactly against the construction oracle.

Reference contrast: the reference is a single-device sorter with no
joins and one queue submit (reference src/main.rs:727);
this is SURVEY.md §2c's communication layer carrying §7 step 6's join
past both the single-program and the single-device limits.
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_qe.bits import U64
from tpu_qe.exchange.shuffle import AXIS
from tpu_qe.ops.bigjoin import (_JoinState, _lkey_of_index,
                                _rkey_of_index, _rval_of_key,
                                _verify_construction)
from tpu_qe.ops.join import join_fk_scan, searchsorted_u64
from tpu_qe.sort.dbigsort import _exchange_fn, _quantize
from tpu_qe.table import Table

_ONES = jnp.uint32(0xFFFFFFFF)


# ----------------------------------------------------------------- phase A

def _runner_fn(mesh: Mesh, n_local: int, run_size: int, n_r: int,
               seed: int, side: str):
    """Per-side phase-A program: every device sorts ITS run r."""

    def body(r):
        d = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        base = d * jnp.uint32(n_local) + r * jnp.uint32(run_size)
        idx = base + jnp.arange(run_size, dtype=jnp.uint32)
        if side == "right":
            key = _rkey_of_index(idx, seed)
            hi, lo = jax.lax.sort([key.hi, key.lo], num_keys=2,
                                  is_stable=False)
            return lo, hi
        key = _lkey_of_index(idx, n_r, seed)
        hi, lo, pay = jax.lax.sort([key.hi, key.lo, idx], num_keys=3,
                                   is_stable=False)
        return lo, hi, pay

    nc = 2 if side == "right" else 3
    fn = shard_map(body, mesh=mesh, in_specs=(P(),),
                   out_specs=tuple([P(AXIS)] * nc), check_vma=False)
    return jax.jit(fn)


# ----------------------------------------------------------------- phase B

def _planner_fn(mesh: Mesh, n_runs_l: int, n_runs_r: int,
                n_buckets_total: int, per_run: int, run_size: int):
    """Union splitters at the (D*B)-quantiles + per-run boundaries for
    BOTH sides (exact searchsorted — zero sampling error downstream)."""

    def body(*cols):
        # cols: n_runs_l pairs (lo, hi) then n_runs_r pairs
        stride = max(run_size // per_run, 1)
        sel = (jnp.arange(per_run) * stride) % run_size
        n_pairs = n_runs_l + n_runs_r
        s_lo = jnp.concatenate(
            [jnp.take(cols[2 * r], sel) for r in range(n_pairs)])
        s_hi = jnp.concatenate(
            [jnp.take(cols[2 * r + 1], sel) for r in range(n_pairs)])
        g_lo = jax.lax.all_gather(s_lo, AXIS).reshape(-1)
        g_hi = jax.lax.all_gather(s_hi, AXIS).reshape(-1)
        g_hi, g_lo = jax.lax.sort([g_hi, g_lo], num_keys=2, is_stable=False)
        total = g_lo.shape[0]
        q = (jnp.arange(1, n_buckets_total) * total) // n_buckets_total
        sp = U64(g_lo[q], g_hi[q])
        bounds = jnp.stack([
            searchsorted_u64(U64(cols[2 * r], cols[2 * r + 1]), sp,
                             side="left")
            for r in range(n_pairs)])            # (Rl+Rr, S-1) per device
        return bounds

    specs = tuple([P(AXIS)] * (2 * (n_runs_l + n_runs_r)))
    fn = shard_map(body, mesh=mesh, in_specs=specs,
                   out_specs=P(AXIS, None), check_vma=False)
    return jax.jit(fn)


# ----------------------------------------------------------------- phase C

def _joiner_fn(mesh: Mesh, n_runs_l: int, n_runs_r: int, n_dev: int,
               cap_seg_l: int, cap_seg_r: int,
               agg: tuple | None = None):
    """Per-bucket join + construction-exact verification, all devices at
    once. Segments arrive key-sorted per (run, source); join_fk_scan
    sorts the combined stream itself, so no pre-merge is needed.

    agg=(n_groups, partial_cap): FUSE a partial GROUP BY of the joined
    values into the bucket program (ops/bigpipe.py's consume step, in
    program — the joined rows never leave the bucket) and append the
    5-plane sentinel-padded partial table to the outputs (the
    ops/bigagg.py padding discipline, so dbigagg's combiner merges the
    bucket tables unchanged). Used by ops/dbigpipe.py."""

    def body(st_l, dl_l, sz_l, st_r, dl_r, sz_r, *blocks):
        # plans: (R, D) per device per side; blocks: n_runs_l triples of
        # (D, cap_blk_l) then n_runs_r pairs of (D, cap_blk_r)
        def gather_segs(n_runs, ncols, plan_st, plan_dl, plan_sz, off,
                        cap_seg, fills):
            segs = [[] for _ in range(ncols + 1)]   # cols + valid
            ar = jnp.arange(cap_seg, dtype=jnp.uint32)
            for r in range(n_runs):
                cols = blocks[off + ncols * r: off + ncols * (r + 1)]
                for s in range(n_dev):
                    d = plan_dl[r, s].astype(jnp.uint32)
                    sz = plan_sz[r, s].astype(jnp.uint32)
                    in_seg = (ar >= d) & (ar < d + sz)
                    si = jnp.int32(s)
                    for c in range(ncols):
                        sl = jax.lax.dynamic_slice(
                            cols[c], (si, plan_st[r, s]), (1, cap_seg))[0]
                        segs[c].append(jnp.where(in_seg, sl, fills[c]))
                    segs[ncols].append(in_seg)
            return [jnp.concatenate(s) for s in segs]

        l_fill = (_ONES, _ONES, jnp.uint32(0))
        s_llo, s_lhi, s_lidx, l_valid = gather_segs(
            n_runs_l, 3, st_l, dl_l, sz_l, 0, cap_seg_l, l_fill)
        s_rlo, s_rhi, r_valid = gather_segs(
            n_runs_r, 2, st_r, dl_r, sz_r, 3 * n_runs_l, cap_seg_r,
            (_ONES, _ONES))

        rkey = U64(s_rlo, s_rhi)
        rv = _rval_of_key(rkey)
        out, matched = join_fk_scan(
            Table({"lidx": s_lidx}), Table({"rv": rv}),
            U64(s_llo, s_lhi), rkey, l_valid=l_valid, r_valid=r_valid)

        scalars = _verify_construction(
            s_lidx, l_valid, s_llo, s_lhi, out["rv"], matched) + (
            jnp.sum(l_valid.astype(jnp.uint32)),
            jnp.sum(r_valid.astype(jnp.uint32)))
        outs = tuple(x.reshape(1) for x in scalars)
        if agg is not None:
            from tpu_qe.ops.bigpipe import _bucket_partial
            n_groups, partial_cap = agg
            outs = outs + _bucket_partial(
                s_llo, s_lhi, out["rv"], matched.astype(jnp.uint32),
                l_valid.astype(jnp.uint32), n_groups=n_groups,
                partial_cap=partial_cap)
        return outs

    plan = P(AXIS, None)
    n_blk = 3 * n_runs_l + 2 * n_runs_r
    n_out = 6 + (5 if agg is not None else 0)
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(plan,) * 6 + (plan,) * n_blk,
        out_specs=tuple([P(AXIS)] * n_out), check_vma=False)
    return jax.jit(fn)


@dataclasses.dataclass(frozen=True)
class DBigJoinResult:
    n_l: int
    n_r: int
    n_dev: int
    seconds: float
    rows_per_s: float
    matched: int
    match_ok: bool
    val_ok: bool
    count_ok: bool
    phase_a_s: float
    phase_b_s: float
    phase_x_s: float
    phase_c_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return self.match_ok and self.val_ok and self.count_ok


class _DJoinState(_JoinState):
    N_SCALARS = 6  # per device: match_ok, val_ok, n_matched, n_even, l, r

    @staticmethod
    def _path(directory: str) -> str:
        return os.path.join(directory, "dbigjoin_state.npz")


def join_big_distributed(n_l: int, n_r: int, mesh: Mesh,
                         run_size: int = 1 << 26,
                         buckets_per_dev: int | None = None, seed: int = 7,
                         samples_per_run: int = 4096,
                         verbose: bool = False,
                         checkpoint_dir: str | None = None,
                         force_composed: bool = False,
                         aggregate_groups: int | None = None):
    """Distributed + out-of-core FK join of n_l x n_r generated rows.

    Both sides must be divisible by D * run_size. Bucket joins run on
    the device owning the bucket's key range; every left row's match
    flag and joined value are verified on device against the generator's
    closed form (ops/bigjoin.py data model: matches are exactly the even
    left indices). Peak per-device HBM ~ local runs of both sides + one
    bucket's join working set.

    checkpoint_dir: same resume contract as the other big drivers — the
    splitter bounds and per-bucket-round scalars persist; phases A and X
    regenerate deterministically on restart, completed bucket rounds
    replay their recorded per-device scalars.

    With D == 1 the exchange has nothing to move, so the call DELEGATES
    to the single-chip join_big (same data model and verification;
    returns its BigJoinResult). force_composed=True keeps the composed
    machinery at D=1 for tests/machinery measurements.

    aggregate_groups: FUSE a partial GROUP BY of the joined values into
    every bucket program (group = hash(join key) mod aggregate_groups,
    matched rows only — the ops/dbigpipe.py composition); returns
    (DBigJoinResult, partial_tables) where partial_tables is one
    5-plane sharded table per bucket round, ready for dbigagg's
    combiner. Incompatible with checkpoint_dir (skipped rounds would
    have no tables); the fused caller handles its own persistence.
    """
    n_dev = int(mesh.shape[AXIS])
    if n_dev == 1 and not force_composed:
        from tpu_qe.ops.bigjoin import join_big
        return join_big(n_l, n_r, n_buckets=buckets_per_dev, seed=seed,
                        verbose=verbose, checkpoint_dir=checkpoint_dir)
    assert n_l % (n_dev * run_size) == 0, (n_l, n_dev, run_size)
    assert n_r % (n_dev * run_size) == 0, (n_r, n_dev, run_size)
    assert n_l < (1 << 32) and n_r < (1 << 32)
    nl_local, nr_local = n_l // n_dev, n_r // n_dev
    n_runs_l, n_runs_r = nl_local // run_size, nr_local // run_size
    if buckets_per_dev is None:
        buckets_per_dev = max(1, int(np.ceil(
            (nl_local + nr_local) / (1 << 26))))
    n_b = buckets_per_dev
    S = n_dev * n_b
    per_run = min(samples_per_run, run_size)
    quantum = 1 << 20 if run_size >= (1 << 22) else 256

    rep = NamedSharding(mesh, P())
    plan_sh = NamedSharding(mesh, P(AXIS, None))

    def _rep(x):
        return jax.device_put(x, rep)

    def _plan_put(x):
        return jax.device_put(jnp.asarray(x, jnp.int32), plan_sh)

    # ---- AOT compiles ----
    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    lrun_exec = _runner_fn(mesh, nl_local, run_size, n_r, seed,
                           "left").lower(_rep(jnp.uint32(0))).compile()
    rrun_exec = _runner_fn(mesh, nr_local, run_size, n_r, seed,
                           "right").lower(_rep(jnp.uint32(0))).compile()
    compile_s = time.perf_counter() - tc0

    # ---- phase A ----
    t0 = time.perf_counter()
    lruns = [lrun_exec(_rep(jnp.uint32(r))) for r in range(n_runs_l)]
    rruns = [rrun_exec(_rep(jnp.uint32(r))) for r in range(n_runs_r)]
    np.asarray(jax.device_get(lruns[-1][0][-1:]))
    np.asarray(jax.device_get(rruns[-1][0][-1:]))  # fence
    t_a = time.perf_counter() - t0

    # ---- phase B (a resumed run reuses the persisted plan) ----
    meta = np.asarray([n_l, n_r, n_dev, run_size, n_b, seed, per_run],
                      np.int64)
    state = (_DJoinState.load(checkpoint_dir, meta)
             if checkpoint_dir is not None else None)
    if state is not None:
        bounds = state.bounds.reshape(n_dev, n_runs_l + n_runs_r, S - 1)
        t_b = 0.0
    else:
        tcp = time.perf_counter()
        planner = _planner_fn(mesh, n_runs_l, n_runs_r, S, per_run,
                              run_size)
        flat_keys = tuple(a for run in (lruns + rruns) for a in run[:2])
        plan_exec = planner.lower(*flat_keys).compile()
        compile_s += time.perf_counter() - tcp
        t_b0 = time.perf_counter()
        bounds = np.asarray(plan_exec(*flat_keys)).astype(np.int64)
        bounds = bounds.reshape(n_dev, n_runs_l + n_runs_r, S - 1)
        t_b = time.perf_counter() - t_b0
        if checkpoint_dir is not None:
            state = _DJoinState.fresh(
                checkpoint_dir, meta, bounds, n_b,
                n_scalars=n_dev * _DJoinState.N_SCALARS)

    zeros = np.zeros((n_dev, n_runs_l + n_runs_r, 1), dtype=np.int64)
    full = np.full_like(zeros, run_size)
    pos = np.concatenate([zeros, bounds, full], axis=2)   # (D, R, S+1)
    pos_l, pos_r = pos[:, :n_runs_l], pos[:, n_runs_l:]

    def side_caps(pos_side, n_dev):
        blk_edge = pos_side[:, :, 0:S + 1:n_b]            # (D, R, D+1)
        blk_start = blk_edge[:, :, :-1]
        blk_size = blk_edge[:, :, 1:] - blk_start
        cap_blk = _quantize(int(blk_size.max()), quantum, run_size)
        eye = np.eye(n_dev, dtype=bool)[:, None, :]
        off_max = int(np.where(eye, 0, blk_size).max()) if n_dev > 1 else 0
        cap_off = _quantize(off_max, quantum, cap_blk) if n_dev > 1 else 16
        seg_size = pos_side[:, :, 1:] - pos_side[:, :, :-1]
        cap_seg = _quantize(int(seg_size.max()), quantum, cap_blk)
        return blk_start, blk_size, cap_blk, cap_off, cap_seg, eye

    bs_l, bz_l, cb_l, co_l, cs_l, eye = side_caps(pos_l, n_dev)
    bs_r, bz_r, cb_r, co_r, cs_r, _ = side_caps(pos_r, n_dev)
    # one bucket's combined padded stream must fit the in-core join
    assert (n_runs_l * n_dev * cs_l + n_runs_r * n_dev * cs_r) < (1 << 30), \
        ("bucket join exceeds join_fk_scan's combined cap; raise "
         "buckets_per_dev", cs_l, cs_r)
    if verbose:
        print(f"dbigjoin: D={n_dev} Rl={n_runs_l} Rr={n_runs_r} B={n_b} "
              f"cap_blk_l={cb_l} cap_seg_l={cs_l} "
              f"cap_blk_r={cb_r} cap_seg_r={cs_r}")

    # ---- phase X: per-run segment exchange for each side ----
    tcx = time.perf_counter()
    lex = _exchange_fn(mesh, n_dev, cb_l, co_l)
    rex = _exchange_fn(mesh, n_dev, cb_r, co_r, fills=(_ONES, _ONES))
    iplan = _plan_put(np.zeros((n_dev, n_dev), np.int32))
    lex_exec = lex.lower(iplan, iplan, iplan, iplan, iplan,
                         *lruns[0]).compile()
    rex_exec = rex.lower(iplan, iplan, iplan, iplan, iplan,
                         *rruns[0]).compile()
    compile_s += time.perf_counter() - tcx

    def do_exchange(runs, blk_start, blk_size, cap_off, cap_blk, ex_exec):
        blocks = []
        off_ceiling = max(run_size - cap_off, 0)
        diag_ceiling = max(run_size - cap_blk, 0)
        for r in range(len(runs)):
            raw = blk_start[:, r, :]
            clamped = np.minimum(raw, off_ceiling)
            clamped_d = np.minimum(raw, diag_ceiling)
            blocks.append(ex_exec(
                _plan_put(clamped), _plan_put(raw - clamped),
                _plan_put(blk_size[:, r, :]), _plan_put(clamped_d),
                _plan_put(raw - clamped_d), *runs[r]))
            runs[r] = None
        return blocks

    t_x0 = time.perf_counter()
    lblocks = do_exchange(lruns, bs_l, bz_l, co_l, cb_l, lex_exec)
    rblocks = do_exchange(rruns, bs_r, bz_r, co_r, cb_r, rex_exec)
    np.asarray(jax.device_get(lblocks[-1][0][-1:, -1:]))
    np.asarray(jax.device_get(rblocks[-1][0][-1:, -1:]))  # fence
    t_x = time.perf_counter() - t_x0

    # ---- phase C: per-bucket joins (all devices in parallel) ----
    tcj = time.perf_counter()
    agg = None
    if aggregate_groups is not None:
        assert checkpoint_dir is None, \
            "aggregate_groups is incompatible with checkpoint_dir"
        # a bucket cannot hold more distinct groups than left rows: cap
        # the partial table at the bucket's static left capacity
        pc = min(aggregate_groups, n_runs_l * n_dev * cs_l)
        pc = -(-pc // 128) * 128
        agg = (aggregate_groups, pc)
    joiner = _joiner_fn(mesh, n_runs_l, n_runs_r, n_dev, cs_l, cs_r,
                        agg=agg)
    mplan_l = _plan_put(np.zeros((n_dev * n_runs_l, n_dev), np.int32))
    mplan_r = _plan_put(np.zeros((n_dev * n_runs_r, n_dev), np.int32))
    flat_blocks = [a for blk in (lblocks + rblocks) for a in blk]
    join_exec = joiner.lower(mplan_l, mplan_l, mplan_l,
                             mplan_r, mplan_r, mplan_r,
                             *flat_blocks).compile()
    compile_s += time.perf_counter() - tcj

    def bucket_plans(pos_side, blk_start, cap_blk, cap_off, cap_seg,
                     n_runs, b):
        # device t's bucket b = global bucket g = t*B + b; segment start
        # within the (src, run) block + host pre-clamp for the cap_seg
        # window (two-tier: diagonal blocks packed at cap_blk, the rest
        # at cap_off — mirror the exchange's placement)
        g = (np.arange(n_dev) * n_b + b)                  # per dest t
        seg_st, seg_sz = [], []
        off_ceiling = max(run_size - cap_off, 0)
        diag_ceiling = max(run_size - cap_blk, 0)
        ceil_mat = np.where(eye, diag_ceiling, off_ceiling)  # (D,1,D)
        blk_clamped = np.minimum(blk_start, ceil_mat)
        blk_delta = blk_start - blk_clamped               # (D, R, D)
        seg_ceiling = max(cap_blk - cap_seg, 0)
        st = np.zeros((n_dev, n_runs, n_dev), np.int64)   # (dest, r, src)
        dl = np.zeros_like(st)
        sz = np.zeros_like(st)
        for t in range(n_dev):
            gs = g[t]
            # within-run absolute start/size of global bucket gs
            a = pos_side[:, :, gs]                        # (src D, R)
            e = pos_side[:, :, gs + 1]
            rel = a - blk_start[:, :, t] + blk_delta[:, :, t]
            clamped = np.minimum(rel, seg_ceiling)
            st[t] = clamped.swapaxes(0, 1)        # (src, R) -> (R, src)
            dl[t] = (rel - clamped).swapaxes(0, 1)
            sz[t] = (e - a).swapaxes(0, 1)
        return st, dl, sz

    t_c0 = time.perf_counter()
    skip = set()
    if state is not None:
        skip = {b for b in range(n_b) if state.done[b]}
        if verbose and skip:
            print(f"dbigjoin: resuming — {len(skip)}/{n_b} bucket rounds "
                  "already joined")
    pending = {}
    for b in range(n_b):
        if b in skip:
            continue
        stl, dll, szl = bucket_plans(pos_l, bs_l, cb_l, co_l, cs_l,
                                     n_runs_l, b)
        str_, dlr, szr = bucket_plans(pos_r, bs_r, cb_r, co_r, cs_r,
                                      n_runs_r, b)

        def put_plan(x, n_runs):
            # (dest, r, src) -> per-dest (R, D) rows stacked: (D*R, D)
            return _plan_put(x.reshape(n_dev * n_runs, n_dev))

        pending[b] = join_exec(
            put_plan(stl, n_runs_l), put_plan(dll, n_runs_l),
            put_plan(szl, n_runs_l),
            put_plan(str_, n_runs_r), put_plan(dlr, n_runs_r),
            put_plan(szr, n_runs_r), *flat_blocks)
    matched = expected = rows_l = rows_r = 0
    m_ok = v_ok = True
    for b in range(n_b):
        if b in skip:
            vals = state.scalars[b].reshape(n_dev, _DJoinState.N_SCALARS)
            mo, vo, nm, ne, nl_b, nr_b = vals.T
        else:
            out = [np.asarray(x) for x in pending[b][:6]]
            mo, vo, nm, ne, nl_b, nr_b = out
            if state is not None:
                state.record(b, np.stack(out, axis=1).reshape(-1))
        m_ok &= bool(mo.all())
        v_ok &= bool(vo.all())
        matched += int(nm.sum())
        expected += int(ne.sum())
        rows_l += int(nl_b.sum())
        rows_r += int(nr_b.sum())
    t_c = time.perf_counter() - t_c0

    count_ok = (rows_l == n_l and rows_r == n_r
                and matched == expected == (n_l + 1) // 2)
    dt = t_a + t_b + t_x + t_c
    res = DBigJoinResult(
        n_l=n_l, n_r=n_r, n_dev=n_dev, seconds=dt, rows_per_s=n_l / dt,
        matched=matched, match_ok=m_ok, val_ok=v_ok, count_ok=count_ok,
        phase_a_s=t_a, phase_b_s=t_b, phase_x_s=t_x, phase_c_s=t_c,
        compile_s=compile_s)
    if verbose:
        print(f"dbigjoin: matched={matched}/{expected} rows_l={rows_l} "
              f"rows_r={rows_r} A={t_a:.2f} X={t_x:.2f} C={t_c:.2f} "
              f"ok={res.all_ok}")
    if aggregate_groups is not None:
        return res, [pending[b][6:] for b in range(n_b)]
    return res
