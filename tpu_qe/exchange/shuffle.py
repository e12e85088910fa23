"""Keyed shuffle primitives over a device mesh (shard_map bodies).

The communication backend the reference lacks entirely (its only transport
is one wgpu queue submit, /root/reference/src/main.rs:727) — SURVEY.md §2c's
mandated first-class component. These functions run INSIDE shard_map and
compose into the distributed operators:

  sample_splitters   all_gather a strided oversample -> global quantile
                     splitters (skew-robust: Zipf keys still balance)
  route_by_splitters dest device = #(splitters < key)
  exchange           stable local partition by dest + padded fixed-size
                     all_to_all with exact per-pair counts and
                     overflow detection (static shapes: the jit-friendly
                     stand-in for a ragged all_to_all). Two-tier capacity:
                     diagonal (stay-local) rows bypass the collective with
                     full n_local capacity; only off-diagonal buckets pay
                     `capacity`, which `offdiag_demand` can size to the
                     measured demand (plan-then-execute)

distributed_sort / distributed_join_fk / distributed_aggregate are thin
compositions: exchange + the corresponding local operator per shard.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

AXIS = "x"
_ONES = jnp.uint32(0xFFFFFFFF)


def cmp_gt(lo_a, hi_a, lo_b, hi_b):
    """u64 pair comparison a > b."""
    return (hi_a > hi_b) | ((hi_a == hi_b) & (lo_a > lo_b))


def sample_splitters(lo, hi, n_dev: int, samples_per_dev: int,
                     axis: str = AXIS, n_valid=None):
    """Global D-quantile splitters from a strided per-device oversample.

    n_valid (optional, dynamic): sample only the first n_valid rows of
    each shard — used when the arrays carry a valid prefix followed by
    padding (e.g. partial aggregation results), where a static stride
    would be dominated by pad sentinels.
    """
    n_local = lo.shape[0]
    if n_valid is None:
        stride = max(n_local // samples_per_dev, 1)
        idx = (jnp.arange(samples_per_dev) * stride) % n_local
    else:
        nv = jnp.maximum(n_valid.astype(jnp.uint32), jnp.uint32(1))
        stride = jnp.maximum(nv // jnp.uint32(samples_per_dev),
                             jnp.uint32(1))
        idx = (jnp.arange(samples_per_dev, dtype=jnp.uint32) * stride) % nv
    g_lo = jax.lax.all_gather(jnp.take(lo, idx), axis).reshape(-1)
    g_hi = jax.lax.all_gather(jnp.take(hi, idx), axis).reshape(-1)
    g_hi, g_lo = jax.lax.sort([g_hi, g_lo], num_keys=2, is_stable=False)
    total = n_dev * samples_per_dev
    sp_idx = (jnp.arange(1, n_dev) * total) // n_dev
    return g_lo[sp_idx], g_hi[sp_idx]  # (D-1,) each


def route_by_splitters(lo, hi, sp_lo, sp_hi):
    """dest device = number of splitters strictly below the key."""
    gt = cmp_gt(lo[None, :], hi[None, :], sp_lo[:, None], sp_hi[:, None])
    return jnp.sum(gt.astype(jnp.uint32), axis=0)


def sample_splitters_pos(lo, hi, pos, n_dev: int, samples_per_dev: int,
                         axis: str = AXIS):
    """(key, position) splitters — heavy-key splitting with stability.

    Routing on bare keys cannot balance a single hot key (all duplicates
    share one destination; worst case needs capacity_factor = n_dev). With
    the global position appended as the least-significant key, quantiles
    fall WITHIN runs of equal keys, splitting any hot key across devices;
    global order is preserved because duplicates are position-ordered
    across the device range, and per-source positions are contiguous so
    source-rank receive order equals position order (stability).
    """
    n_local = lo.shape[0]
    stride = max(n_local // samples_per_dev, 1)
    idx = (jnp.arange(samples_per_dev) * stride) % n_local
    g_lo = jax.lax.all_gather(lo[idx], axis).reshape(-1)
    g_hi = jax.lax.all_gather(hi[idx], axis).reshape(-1)
    g_pos = jax.lax.all_gather(pos[idx], axis).reshape(-1)
    g_hi, g_lo, g_pos = jax.lax.sort([g_hi, g_lo, g_pos], num_keys=3,
                                     is_stable=False)
    total = n_dev * samples_per_dev
    sp_idx = (jnp.arange(1, n_dev) * total) // n_dev
    return g_lo[sp_idx], g_hi[sp_idx], g_pos[sp_idx]


def sample_splitters_multi(planes, n_dev: int, samples_per_dev: int,
                           axis: str = AXIS):
    """Lexicographic splitters over arbitrary u32 key planes.

    `planes` is a list of (n_local,) u32 arrays in MAJOR -> minor
    significance order (e.g. [key_hi, key_lo, order_bits, position]) —
    the generalization of sample_splitters_pos that distributed windows
    need: their global order is (key, ORDER, position), so quantiles
    must be drawn on the same composite or a partition's rows land on
    devices out of order (appending the unique position as the minor
    plane keeps the hot-key splitting property). Returns a list of
    (n_dev-1,) splitter arrays, one per plane.
    """
    n_local = planes[0].shape[0]
    stride = max(n_local // samples_per_dev, 1)
    idx = (jnp.arange(samples_per_dev) * stride) % n_local
    g = [jax.lax.all_gather(p[idx], axis).reshape(-1) for p in planes]
    g = jax.lax.sort(g, num_keys=len(g), is_stable=False)
    total = n_dev * samples_per_dev
    sp_idx = (jnp.arange(1, n_dev) * total) // n_dev
    return [p[sp_idx] for p in g]


def route_by_splitters_multi(planes, sps):
    """dest = number of splitters lexicographically strictly below the
    row, over matched major->minor plane lists (see
    sample_splitters_multi)."""
    gt = jnp.zeros((sps[0].shape[0], planes[0].shape[0]), bool)
    for p, sp in zip(reversed(planes), reversed(sps)):
        p_gt = p[None, :] > sp[:, None]
        p_eq = p[None, :] == sp[:, None]
        gt = p_gt | (p_eq & gt)
    return jnp.sum(gt.astype(jnp.uint32), axis=0)


def route_by_splitters_pos(lo, hi, pos, sp_lo, sp_hi, sp_pos):
    """dest = number of (key, position) splitters strictly below the row."""
    k_gt = cmp_gt(lo[None, :], hi[None, :], sp_lo[:, None], sp_hi[:, None])
    k_eq = (lo[None, :] == sp_lo[:, None]) & (hi[None, :] == sp_hi[:, None])
    gt = k_gt | (k_eq & (pos[None, :] > sp_pos[:, None]))
    return jnp.sum(gt.astype(jnp.uint32), axis=0)


def _partition_by_dest(dest, cols, n_dev: int):
    """Stable partition of rows by destination; returns (cols_s, dest_s,
    counts, offsets) with counts/offsets per destination."""
    n_local = dest.shape[0]
    # Partition by destination with an unstable sort: the key packs dest
    # into the high bits and the row index below, so order within a
    # destination is row order (stability for free, no stable-sort cost).
    dbits = max(int(np.ceil(np.log2(max(n_dev, 2)))), 1)
    if n_local < (1 << (32 - dbits)):
        idx = jnp.arange(n_local, dtype=jnp.uint32)
        packed = (dest << jnp.uint32(32 - dbits)) | idx
        parts = jax.lax.sort([packed] + list(cols), num_keys=1,
                             is_stable=False)
        dest_s = parts[0] >> jnp.uint32(32 - dbits)
    else:
        parts = jax.lax.sort([dest] + list(cols), num_keys=1, is_stable=True)
        dest_s = parts[0]
    cols_s = list(parts[1:])
    counts = jnp.sum(
        (dest_s[:, None] == jnp.arange(n_dev, dtype=jnp.uint32)[None, :])
        .astype(jnp.uint32), axis=0)
    offsets = jnp.cumsum(counts) - counts
    return cols_s, dest_s, counts, offsets


def pow2_capacity(demand: int, slack: float = 1.05) -> int:
    """Demand -> static exchange capacity: slack margin + next power of
    two (so repeated runs on similar data reuse one compiled executable
    instead of recompiling per exact demand). Single source of truth for
    every plan-then-execute caller."""
    need = max(int(np.ceil(demand * slack)), 16)
    return 1 << int(np.ceil(np.log2(need)))


def offdiag_demand(dest, n_dev: int, axis: str = AXIS):
    """Max off-diagonal (src,dst) bucket size across the mesh (scalar u32).

    The planning half of demand-sized exchange: run this (cheap — one
    histogram + pmax) in a first jitted program, read the scalar back, and
    size `capacity` for the real exchange to the actual demand instead of
    a uniform worst-case factor. Diagonal (dest == own rank) traffic is
    excluded — it never enters the all_to_all (see `exchange`).
    """
    counts = jnp.sum(
        (dest[:, None] == jnp.arange(n_dev, dtype=jnp.uint32)[None, :])
        .astype(jnp.uint32), axis=0)
    me = jax.lax.axis_index(axis).astype(jnp.uint32)
    off = jnp.where(jnp.arange(n_dev, dtype=jnp.uint32) == me, 0, counts)
    return jax.lax.pmax(jnp.max(off), axis)


def exchange(dest, cols, pad_values, n_dev: int, capacity: int,
             axis: str = AXIS):
    """Move rows to their dest device: local keep + padded all_to_all.

    Two-tier capacity model: rows whose destination is their own device
    NEVER enter the all_to_all — they are kept in a local tail block with
    full n_local capacity (pure HBM, no interconnect cost). Only
    off-diagonal (src != dst) buckets consume `capacity`, so identity /
    all-equal-key routes no longer inflate the receive buffer by a factor
    of n_dev (the round-1 uniform model priced the zero-movement route at
    n_local per pair). Use `offdiag_demand` to size `capacity` to actual
    demand.

    Args:
      dest: (n_local,) uint32 destination device per row.
      cols: list of (n_local,) uint32 columns to move (keys first by
        convention; all carried through one stable partition so relative
        order within a destination is preserved — stability).
      pad_values: per-column uint32 fill for exchange padding.
    Returns:
      (recv_cols, recv_flag, recv_rank, recv_counts, overflow):
        recv_cols: list of (n_dev * capacity + n_local,) received columns:
          first n_dev*capacity entries are off-diagonal blocks grouped by
          source rank (own rank's block is all padding), the n_local tail
          holds the rows that stayed local;
        recv_flag: 1 where the slot is padding;
        recv_rank: u32 stability rank — strictly increasing over
          (source rank, within-source order); sort by it to recover the
          source-rank arrival order the flat layout no longer provides;
        recv_counts: (n_dev,) real rows received from each source
          (including own rank's local rows);
        overflow: scalar u32, nonzero if any OFF-DIAGONAL (src,dst) run
          exceeded capacity (counts stay exact so truncation is
          detectable; local rows cannot overflow).
    """
    n_local = dest.shape[0]
    cols_s, _, counts, offsets = _partition_by_dest(dest, cols, n_dev)
    me = jax.lax.axis_index(axis).astype(jnp.uint32)
    dev_ids = jnp.arange(n_dev, dtype=jnp.uint32)
    # off-diagonal send budget: own bucket contributes nothing to the a2a
    send_counts = jnp.where(dev_ids == me, 0, counts)

    def pack(col, fill):
        colp = jnp.concatenate(
            [col, jnp.full((capacity,), fill, dtype=col.dtype)])

        def one(d):
            run = jax.lax.dynamic_slice(colp, (offsets[d],), (capacity,))
            in_run = jnp.arange(capacity, dtype=jnp.uint32) < send_counts[d]
            return jnp.where(in_run, run, fill)

        return jax.vmap(one)(dev_ids)  # (D, capacity)

    def local_tail(col, fill):
        colp = jnp.concatenate(
            [col, jnp.full((n_local,), fill, dtype=col.dtype)])
        run = jax.lax.dynamic_slice(colp, (offsets[me],), (n_local,))
        in_run = jnp.arange(n_local, dtype=jnp.uint32) < counts[me]
        return jnp.where(in_run, run, fill)

    a2a = functools.partial(jax.lax.all_to_all, axis_name=axis,
                            split_axis=0, concat_axis=0, tiled=False)
    recv_cols = [
        jnp.concatenate([a2a(pack(c, v)).reshape(-1), local_tail(c, v)])
        for c, v in zip(cols_s, pad_values)]
    zeros = jnp.zeros(n_local, jnp.uint32)
    recv_flag = jnp.concatenate([
        a2a(pack(zeros, jnp.uint32(1))).reshape(-1),
        local_tail(zeros, jnp.uint32(1))])
    # stability rank: source-major, within-source order preserved. The
    # off-diagonal region's source is its block index; the local tail's
    # source is own rank. stride M keeps ranks disjoint per source.
    m_stride = jnp.uint32(max(capacity, n_local))
    off_pos = jnp.arange(n_dev * capacity, dtype=jnp.uint32)
    off_rank = (off_pos // jnp.uint32(capacity)) * m_stride \
        + off_pos % jnp.uint32(capacity)
    tail_rank = me * m_stride + jnp.arange(n_local, dtype=jnp.uint32)
    recv_rank = jnp.concatenate([off_rank, tail_rank])
    recv_counts = jax.lax.all_to_all(
        counts.reshape(n_dev, 1), axis, 0, 0).reshape(-1)
    overflow = (jax.lax.pmax(jnp.max(send_counts), axis)
                > jnp.uint32(capacity)).astype(jnp.uint32)
    return recv_cols, recv_flag, recv_rank, recv_counts, overflow
