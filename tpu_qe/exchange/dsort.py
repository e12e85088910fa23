"""Distributed sort over a device mesh (shard_map + collectives).

The reference is single-device — its only "transport" is one wgpu queue
submit (/root/reference/src/main.rs:727) and its cross-workgroup
communication is storage buffers between dispatches. This module is the
multi-chip generalization mandated by the build plan (SURVEY.md §2c):
a keyed shuffle built from jax collectives under shard_map.

Algorithm — splitter-based sample sort (skew-robust):

1.  every device draws a fixed oversample of its local keys; an all_gather +
    tiny sort yields global splitters at the D-quantiles, so heavily skewed
    (e.g. Zipf) key distributions still produce balanced destinations —
    this replaces routing on raw high digits;
2.  keys are routed to ``dest = #(splitters < key)`` and exchanged with the
    padded fixed-size all_to_all of tpu_qe.exchange.shuffle (static shapes;
    exact counts; overflow detection);
3.  each device stably sorts what it received; pad sentinels carry an
    invalid flag sorted after every real key (a real all-ones key is still
    ordered correctly).

Within-device sorted runs concatenated in mesh order form the globally
sorted sequence; stability holds because routing preserves source order,
all_to_all concatenates in source-rank order, and local sorts are stable.

Exchange/compute overlap (``overlap=k``): the monolithic all_to_all and
local sort have a full data dependence, so k SUB-exchanges break it: the
destination-partitioned rows are sliced into k contiguous ranges, each
exchanged independently, and each received chunk is pre-sorted
immediately — chunk j's local sort has no data dependence on sub-exchange
j+1, so XLA's latency-hiding scheduler runs it while the next collective
is in flight (the per-chunk sorts are ~85% of local compute). The
non-overlappable tail is a log2(k)-round bitonic MERGE tree over the
pre-sorted runs — O(log n) compare-exchange stages per round instead of
the O(log^2 n) of a full re-sort, so only ~15% of the local work must
wait for the last chunk. Results are bit-identical to the monolithic
path (the merge network realizes the same unique total order
(key, stability-rank) the one-shot sort does). This fills the SURVEY §2c
overlap row; contrast the reference's single queue submit
(/root/reference/src/main.rs:727).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from tpu_qe.bits import U64
from tpu_qe.exchange.shuffle import (AXIS, exchange,
                                     route_by_splitters_pos,
                                     sample_splitters_pos)
from tpu_qe.sort.merge import merge_tree as _merge_tree

_ONES = jnp.uint32(0xFFFFFFFF)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D device mesh over the sort axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


class DistSortResult(NamedTuple):
    """Padded per-device sorted runs.

    Per-device run length depends on the path: D*capacity + n_local for
    the monolithic exchange (off-diagonal blocks + local tail), and
    k * next_pow2(D*capacity + n_local/k) with overlap=k. Don't assume a
    layout — use ``valid`` (per device): the first valid[d] elements of
    device d's run are the real rows, sorted.
    """

    key: U64
    payloads: tuple
    valid: jnp.ndarray


def _dsort_shard(lo, hi, *payloads, n_dev: int, samples_per_dev: int,
                 capacity: int):
    """Per-shard body (runs under shard_map; axis name AXIS)."""
    # (key, global position) splitters: hot keys split across devices with
    # stability (see shuffle.sample_splitters_pos). Per-source positions
    # are contiguous, so rank-ordered receive == position order.
    n_local = lo.shape[0]
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    gpos = my * jnp.uint32(n_local) + jnp.arange(n_local, dtype=jnp.uint32)
    sp_lo, sp_hi, sp_pos = sample_splitters_pos(lo, hi, gpos, n_dev,
                                                samples_per_dev)
    dest = route_by_splitters_pos(lo, hi, gpos, sp_lo, sp_hi, sp_pos)

    cols = [lo, hi] + list(payloads)
    pads = [_ONES, _ONES] + [jnp.uint32(0)] * len(payloads)
    recv, recv_flag, recv_rank, recv_counts, overflow = exchange(
        dest, cols, pads, n_dev, capacity)

    # local sort of received data: the third key packs the pad flag (bit
    # 31: sentinels after equal real keys) over the exchange's stability
    # rank (source-major order — the diagonal rows live in a local tail
    # block, so flat position is no longer source order), so the sort can
    # run unstable.
    flag_key = (recv_flag << jnp.uint32(31)) | recv_rank
    res = jax.lax.sort([recv[1], recv[0], flag_key] + recv[2:],
                       num_keys=3, is_stable=False)
    out_hi, out_lo = res[0], res[1]
    out_pay = list(res[3:])
    valid = jnp.sum(recv_counts).reshape(1)
    return (out_lo, out_hi, *out_pay, valid, overflow.reshape(1))


def _dsort_shard_overlap(lo, hi, *payloads, n_dev: int, samples_per_dev: int,
                         capacity: int, k: int):
    """Overlapped per-shard body: k sub-exchanges, per-chunk pre-sorts
    (overlappable with in-flight collectives), bitonic merge tree tail.

    Bit-identical to _dsort_shard's result on the valid prefix: every
    real row carries a globally unique (key, stability-rank) pair and the
    merge network realizes the same total order the one-shot sort does.

    Chunks slice the rows in ORIGINAL order (not destination-partitioned
    order — a dest-major slice would concentrate each chunk on one
    destination and blow the per-chunk budget): each sub-exchange
    partitions its own slice, so per-chunk bucket sizes are ~1/k of the
    full-exchange buckets, and stability holds because chunk j's rows
    precede chunk j+1's in source order.
    """
    n_local = lo.shape[0]
    assert n_local % k == 0, (n_local, k)
    w = n_local // k
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    gpos = my * jnp.uint32(n_local) + jnp.arange(n_local, dtype=jnp.uint32)
    sp_lo, sp_hi, sp_pos = sample_splitters_pos(lo, hi, gpos, n_dev,
                                                samples_per_dev)
    dest = route_by_splitters_pos(lo, hi, gpos, sp_lo, sp_hi, sp_pos)

    cols_s = [lo, hi] + list(payloads)
    dest_s = dest
    pads = [_ONES, _ONES] + [jnp.uint32(0)] * len(payloads)

    # chunk stride inside exchange(): must match its m_stride for slices
    m_stride = max(capacity, w)
    l0 = n_dev * capacity + w
    l_pow2 = 1 << int(np.ceil(np.log2(max(l0, 2))))

    runs = []
    valid = jnp.zeros((), jnp.uint32)
    ovf = jnp.zeros((), jnp.uint32)
    for j in range(k):
        sl = slice(j * w, (j + 1) * w)
        recv, flag, rank, counts_j, ovf_j = exchange(
            dest_s[sl], [c[sl] for c in cols_s], pads, n_dev, capacity)
        # globalize the per-chunk stability rank: chunk j's rows from a
        # source precede chunk j+1's (contiguous slices of the partition)
        src = rank // jnp.uint32(m_stride)
        within = rank % jnp.uint32(m_stride)
        grank = (src * jnp.uint32(m_stride * k)
                 + jnp.uint32(j * m_stride) + within)
        flagkey = (flag << jnp.uint32(31)) | grank
        pres = jax.lax.sort([recv[1], recv[0], flagkey] + recv[2:],
                            num_keys=3, is_stable=False)
        # pad the sorted run to a power of two (all-max sentinels keep it
        # sorted; pad payloads are 0 and pad flagkeys carry bit 31)
        pad_n = l_pow2 - l0
        padded = [jnp.concatenate([c, jnp.full((pad_n,), v, c.dtype)])
                  for c, v in zip(pres, [_ONES, _ONES, _ONES]
                                  + [jnp.uint32(0)] * len(payloads))]
        runs.append(padded)
        valid = valid + jnp.sum(counts_j)
        ovf = ovf | ovf_j

    res = _merge_tree(runs)
    out_hi, out_lo = res[0], res[1]
    out_pay = list(res[3:])
    return (out_lo, out_hi, *out_pay, valid.reshape(1), ovf.reshape(1))


def _plan_shard(lo, hi, *, n_dev, samples_per_dev):
    """Planning pass: route only, return the max off-diagonal bucket size.

    Must sample/route EXACTLY like _dsort_shard so the measured demand is
    valid for the real exchange (both are deterministic in the inputs).
    """
    from tpu_qe.exchange.shuffle import offdiag_demand

    n_local = lo.shape[0]
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    gpos = my * jnp.uint32(n_local) + jnp.arange(n_local, dtype=jnp.uint32)
    sp_lo, sp_hi, sp_pos = sample_splitters_pos(lo, hi, gpos, n_dev,
                                                samples_per_dev)
    dest = route_by_splitters_pos(lo, hi, gpos, sp_lo, sp_hi, sp_pos)
    return offdiag_demand(dest, n_dev).reshape(1)


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev"))
def plan_sort_capacity(key: U64, mesh: Mesh, samples_per_dev: int = 128):
    """Measure the exact off-diagonal exchange demand for distributed_sort.

    Returns a (n_dev,) replicated-value array whose max is the largest
    off-diagonal (src,dst) bucket; pass ceil to distributed_sort as
    `capacity` (round up to bound recompiles) for a demand-sized receive
    layout instead of a uniform capacity_factor guess.
    """
    n_dev = mesh.shape[AXIS]
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_plan_shard, n_dev=n_dev,
                          samples_per_dev=samples_per_dev),
        mesh=mesh, in_specs=(spec, spec), out_specs=spec, check_vma=False)
    return fn(key.lo, key.hi)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "samples_per_dev",
                                    "capacity_factor", "capacity",
                                    "overlap"))
def distributed_sort(key: U64, *payloads: jnp.ndarray, mesh: Mesh,
                     samples_per_dev: int = 128,
                     capacity_factor: float = 2.0,
                     capacity: int | None = None,
                     overlap: int = 1):
    """Sort u64 keys (+u32 payloads) sharded over a 1-D mesh.

    Args:
      key: U64 with global shape (n,), n divisible by mesh size.
      mesh: 1-D mesh from make_mesh().
      capacity: explicit per-(src,dst) OFF-DIAGONAL bucket capacity
        (e.g. from plan_sort_capacity — demand-sized). Overrides
        capacity_factor. Diagonal (stay-local) rows never consume it.
        With overlap=k the budget applies PER SUB-EXCHANGE (a bucket
        landing entirely inside one chunk needs the full budget there).
      overlap: number of pipelined sub-exchanges (power of two dividing
        the shard size). k > 1 splits the exchange so per-chunk local
        sorts run while later collectives are in flight; the final
        combine is a bitonic merge tree (see module docstring). Results
        on the valid prefix are bit-identical to overlap=1.
    Returns:
      (DistSortResult, overflow_flag). Device d's run holds the d-th quantile
      of the global key order: its first ``valid[d]`` elements, sorted;
      concatenated in mesh order they form the full sorted sequence.
      overflow_flag (u32) is nonzero if an off-diagonal send bucket
      exceeded capacity (raise capacity_factor / re-plan; counts stay
      exact so overflow is detectable).
    """
    n_dev = mesh.shape[AXIS]
    n = key.lo.shape[0]
    assert n % n_dev == 0, (n, n_dev)
    assert n < (1 << 32), n  # global positions travel as u32
    n_local = n // n_dev
    if n_dev == 1:
        # degenerate mesh: no exchange needed — one local stable sort
        # (avoids the capacity_factor-inflated receive buffer)
        res = jax.lax.sort([key.hi, key.lo] + list(payloads), num_keys=2,
                           is_stable=True)
        return (DistSortResult(U64(res[1], res[0]), tuple(res[2:]),
                               jnp.full((1,), n, jnp.uint32)),
                jnp.zeros((1,), jnp.uint32))
    assert overlap >= 1 and (overlap & (overlap - 1)) == 0, overlap
    if overlap > 1:
        assert n_local % overlap == 0, (n_local, overlap)
        w = n_local // overlap
        if capacity is None:
            capacity = int(np.ceil(capacity_factor * w / n_dev))
        capacity = max(capacity, 16)
        # flagkey packs the pad bit over the global rank
        assert n_dev * max(capacity, w) * overlap < (1 << 31), \
            (n_dev, capacity, overlap)
        body = functools.partial(_dsort_shard_overlap, n_dev=n_dev,
                                 samples_per_dev=samples_per_dev,
                                 capacity=capacity, k=overlap)
    else:
        if capacity is None:
            capacity = int(np.ceil(capacity_factor * n_local / n_dev))
        capacity = max(capacity, 16)
        # the local sort packs the pad flag into bit 31 over the
        # stability rank (rank < n_dev * max(capacity, n_local))
        assert n_dev * max(capacity, n_local) < (1 << 31), (n_dev, capacity)
        body = functools.partial(_dsort_shard, n_dev=n_dev,
                                 samples_per_dev=samples_per_dev,
                                 capacity=capacity)

    spec = P(AXIS)
    out_specs = tuple([spec] * (2 + len(payloads))) + (spec, spec)
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=tuple([spec] * (2 + len(payloads))),
        out_specs=out_specs,
        check_vma=False,
    )
    res = fn(key.lo, key.hi, *payloads)
    out_lo, out_hi = res[0], res[1]
    out_pay = tuple(res[2:-2])
    valid, overflow = res[-2], res[-1]
    return DistSortResult(U64(out_lo, out_hi), out_pay, valid), overflow


def auto_capacity(key: U64, mesh: Mesh, samples_per_dev: int = 128,
                  slack: float = 1.05) -> int:
    """Demand-sized off-diagonal capacity for distributed_sort: run the
    planning pass, read back the scalar demand, size via
    shuffle.pow2_capacity."""
    from tpu_qe.exchange.shuffle import pow2_capacity
    demand = int(np.asarray(
        plan_sort_capacity(key, mesh, samples_per_dev=samples_per_dev)).max())
    return pow2_capacity(demand, slack)


def distributed_sort_numpy(keys: np.ndarray, payload: np.ndarray | None,
                           mesh: Mesh, **kw):
    """Host-side wrapper: shard, sort, gather, compact (for tests/benches).

    capacity_factor="auto" plans the exchange first (plan_sort_capacity)
    and sizes the receive layout to measured off-diagonal demand.
    """
    n_dev = mesh.shape[AXIS]
    key = U64.from_numpy(keys)
    sharding = NamedSharding(mesh, P(AXIS))
    key = U64(jax.device_put(key.lo, sharding), jax.device_put(key.hi, sharding))
    payloads = ()
    if payload is not None:
        payloads = (jax.device_put(jnp.asarray(payload), sharding),)
    if kw.get("capacity_factor") == "auto":
        kw = dict(kw)
        del kw["capacity_factor"]
        if n_dev > 1:
            kw["capacity"] = auto_capacity(
                key, mesh,
                samples_per_dev=kw.get("samples_per_dev", 128))
    res, overflow = distributed_sort(key, *payloads, mesh=mesh, **kw)
    if int(np.asarray(overflow).max()):
        raise RuntimeError("exchange capacity overflow; raise capacity_factor")
    lo = np.asarray(res.key.lo).reshape(n_dev, -1)
    hi = np.asarray(res.key.hi).reshape(n_dev, -1)
    valid = np.asarray(res.valid).reshape(n_dev)
    out_keys = []
    out_pay = []
    p = (np.asarray(res.payloads[0]).reshape(n_dev, -1)
         if payload is not None else None)
    for d in range(n_dev):
        v = int(valid[d])
        out_keys.append(lo[d, :v].astype(np.uint64)
                        | (hi[d, :v].astype(np.uint64) << np.uint64(32)))
        if p is not None:
            out_pay.append(p[d, :v])
    keys_out = np.concatenate(out_keys)
    if payload is None:
        return keys_out
    return keys_out, np.concatenate(out_pay)
