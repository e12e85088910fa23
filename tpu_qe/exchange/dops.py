"""Distributed query operators: FK join and GROUP BY over a device mesh.

Data-parallel operators per SURVEY.md §2c ("DP = hash-partitioned tables"):
both are one keyed shuffle (tpu_qe.exchange.shuffle) + the corresponding
local operator per shard.

distributed_join_fk
    Route BOTH sides with the same splitters (sampled from the union of
    both key distributions) so equal keys co-locate, then run the local
    scan join per shard
    with validity masks over the exchange padding. Results return in a
    per-shard padded layout carrying each left row's GLOBAL index, so the
    host wrapper can restore original order.

distributed_aggregate
    Classic two-phase aggregation: (1) local group_aggregate per shard —
    this is also the exchange-volume reducer; (2) shuffle the (far fewer)
    partial groups by key; (3) local combine per shard. Padding slots carry
    neutral elements (count/sum 0, min 0xFFFFFFFF, max 0), so a real
    all-ones key group absorbs them harmlessly and a purely-padding group
    shows count 0 and is dropped by the wrapper.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from tpu_qe.bits import U64
from tpu_qe.exchange.shuffle import (AXIS, exchange,
                                     route_by_splitters,
                                     sample_splitters)
from tpu_qe.table import Table

_ONES = jnp.uint32(0xFFFFFFFF)


# --------------------------------------------------------------------------
# distributed FK join
# --------------------------------------------------------------------------

def _djoin_shard(llo, lhi, lval_cols, rlo, rhi, rval_cols, *, n_dev,
                 samples_per_dev, cap_l, cap_r):
    from tpu_qe.ops.join import join_fk_scan

    (lkey, g, flag_l, left_vals, rkey, r_valid, right_vals,
     overflow) = _djoin_exchange(llo, lhi, lval_cols, rlo, rhi,
                                 rval_cols, n_dev=n_dev,
                                 samples_per_dev=samples_per_dev,
                                 cap_l=cap_l, cap_r=cap_r)
    left = Table({f"_l{i}": c for i, c in enumerate(left_vals)})
    right = Table({f"_r{i}": c for i, c in enumerate(right_vals)})
    out, matched = join_fk_scan(left, right, lkey, rkey,
                                l_valid=flag_l == 0, r_valid=r_valid)
    outs = [g, matched.astype(jnp.uint32), flag_l]
    outs += [out[f"_l{i}"] for i in range(len(lval_cols))]
    outs += [out[f"_r{i}"] for i in range(len(rval_cols))]
    return (*outs, overflow)


def _djoin_exchange(llo, lhi, lval_cols, rlo, rhi, rval_cols, *, n_dev,
                    samples_per_dev, cap_l, cap_r):
    """The join's keyed co-location exchange: (key, position) splitters
    over both sides, straddler broadcast, per-side capacities. Returns
    the per-shard join inputs; shared by the plain distributed join and
    the fused join->GROUP BY."""
    from tpu_qe.exchange.shuffle import (route_by_splitters_pos,
                                         sample_splitters_pos)

    n_local_l = llo.shape[0]
    n_local_r = rlo.shape[0]
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    gidx = my * jnp.uint32(n_local_l) + jnp.arange(n_local_l,
                                                   dtype=jnp.uint32)

    # (key, left-position) splitters over BOTH sides' key distributions:
    # hot LEFT keys split across a device range (a bare-key splitter set
    # cannot balance a key whose duplicates exceed one device's share).
    # Right rows for keys that straddle a splitter — at most n_dev-1 of
    # them, since each straddling key must contain a distinct quantile —
    # are broadcast to every device below so every shard in the key's
    # range can match.
    pos_l = gidx
    pos_r = jnp.zeros(n_local_r, dtype=jnp.uint32)  # rights sort first
    sp_lo, sp_hi, sp_pos = sample_splitters_pos(
        jnp.concatenate([rlo, llo]), jnp.concatenate([rhi, lhi]),
        jnp.concatenate([pos_r, pos_l]), n_dev, samples_per_dev)

    # right rows route to the FIRST device of their key's range; they span
    # further iff routing the same key at maximum position lands higher
    dest_r = route_by_splitters_pos(rlo, rhi, pos_r, sp_lo, sp_hi, sp_pos)
    dest_r_max = route_by_splitters_pos(rlo, rhi, jnp.full(n_local_r, _ONES),
                                        sp_lo, sp_hi, sp_pos)
    spans = dest_r_max > dest_r
    recv_r, flag_r, _, _, ovf_r = exchange(
        dest_r, [rlo, rhi] + list(rval_cols),
        [_ONES, _ONES] + [jnp.uint32(0)] * len(rval_cols), n_dev, cap_r)

    # broadcast the straddling right rows: stable-partition them to the
    # front, keep n_dev-1 slots (the global bound), all_gather
    nspan = max(n_dev - 1, 1)
    assert n_local_r < (1 << 31), n_local_r  # span flag packs into bit 31
    span_key = (jnp.where(spans, jnp.uint32(0), jnp.uint32(1 << 31))
                | jnp.arange(n_local_r, dtype=jnp.uint32))
    sres = jax.lax.sort([span_key, rlo, rhi] + list(rval_cols), num_keys=1,
                        is_stable=False)
    n_span_local = jnp.sum(spans.astype(jnp.uint32))
    # > nspan straddlers is impossible for UNIQUE right keys (each must
    # contain a distinct quantile) but possible with duplicate keys —
    # detect rather than silently truncate the broadcast set
    ovf_span = (n_span_local > jnp.uint32(nspan)).astype(jnp.uint32)
    pad_slot = jnp.arange(nspan, dtype=jnp.uint32) >= n_span_local

    def bc(col, fill):
        # right shards can hold fewer than nspan rows: pad before masking
        colp = col
        if n_local_r < nspan:
            colp = jnp.concatenate(
                [col, jnp.full(nspan - n_local_r, fill, col.dtype)])
        c = jnp.where(pad_slot, fill, colp[:nspan])
        return jax.lax.all_gather(c, AXIS).reshape(-1)  # (n_dev * nspan,)

    bc_lo = bc(sres[1], _ONES)
    bc_hi = bc(sres[2], _ONES)
    bc_vals = [bc(c, jnp.uint32(0)) for c in sres[3:]]
    bc_flag = bc(jnp.zeros(nspan, jnp.uint32), jnp.uint32(1))

    dest_l = route_by_splitters_pos(llo, lhi, pos_l, sp_lo, sp_hi, sp_pos)
    recv_l, flag_l, _, _, ovf_l = exchange(
        dest_l, [llo, lhi, gidx] + list(lval_cols),
        [_ONES, _ONES, _ONES] + [jnp.uint32(0)] * len(lval_cols),
        n_dev, cap_l)

    lkey = U64(recv_l[0], recv_l[1])
    g = recv_l[2]
    # right set = exchanged rows + broadcast straddlers (a straddler also
    # arrives via the normal exchange on its first device — same row, so
    # FK last-wins makes the duplicate harmless)
    rkey = U64(jnp.concatenate([recv_r[0], bc_lo]),
               jnp.concatenate([recv_r[1], bc_hi]))
    r_valid = jnp.concatenate([flag_r == 0, bc_flag == 0])
    left_vals = list(recv_l[3:])
    right_vals = [jnp.concatenate([c, b])
                  for c, b in zip(recv_r[2:], bc_vals)]
    overflow = (ovf_r | ovf_l | ovf_span).reshape(1)
    return (lkey, g, flag_l, left_vals, rkey, r_valid, right_vals,
            overflow)


def _djoin_plan_shard(llo, lhi, rlo, rhi, *, n_dev, samples_per_dev):
    """Planning pass for the join: route both sides (exactly like
    _djoin_shard) and return the max off-diagonal bucket per side."""
    from tpu_qe.exchange.shuffle import (offdiag_demand,
                                         route_by_splitters_pos,
                                         sample_splitters_pos)

    n_local_l = llo.shape[0]
    n_local_r = rlo.shape[0]
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    gidx = my * jnp.uint32(n_local_l) + jnp.arange(n_local_l,
                                                   dtype=jnp.uint32)
    pos_l = gidx
    pos_r = jnp.zeros(n_local_r, dtype=jnp.uint32)
    sp_lo, sp_hi, sp_pos = sample_splitters_pos(
        jnp.concatenate([rlo, llo]), jnp.concatenate([rhi, lhi]),
        jnp.concatenate([pos_r, pos_l]), n_dev, samples_per_dev)
    dest_l = route_by_splitters_pos(llo, lhi, pos_l, sp_lo, sp_hi, sp_pos)
    dest_r = route_by_splitters_pos(rlo, rhi, pos_r, sp_lo, sp_hi, sp_pos)
    return (offdiag_demand(dest_l, n_dev).reshape(1),
            offdiag_demand(dest_r, n_dev).reshape(1))


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev"))
def plan_join_capacity(lkey: U64, rkey: U64, mesh: Mesh,
                       samples_per_dev: int = 128):
    """Measured off-diagonal exchange demand (left, right) for the join."""
    n_dev = mesh.shape[AXIS]
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_djoin_plan_shard, n_dev=n_dev,
                          samples_per_dev=samples_per_dev),
        mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec, spec),
        check_vma=False)
    return fn(lkey.lo, lkey.hi, rkey.lo, rkey.hi)


from tpu_qe.exchange.shuffle import pow2_capacity as _pow2_capacity


def _auto_capacity(kw, mesh, plan_fn, keys, out_names):
    """Resolve capacity_factor="auto" into demand-sized capacities via a
    plan pass (the shared plan-then-execute step of every numpy wrapper:
    measure the off-diagonal demand, size the receive layout to the next
    power of two). Returns kw unchanged unless "auto" was requested."""
    if kw.get("capacity_factor") != "auto":
        return kw
    kw = dict(kw)
    del kw["capacity_factor"]
    kw.pop("capacity_factor_right", None)
    if int(mesh.shape[AXIS]) > 1:
        demands = plan_fn(*keys, mesh,
                          samples_per_dev=kw.get("samples_per_dev", 128))
        if not isinstance(demands, tuple):
            demands = (demands,)
        for name, d in zip(out_names, demands):
            kw[name] = _pow2_capacity(int(np.asarray(d).max()))
    return kw


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev",
                                             "capacity_factor",
                                             "capacity_factor_right",
                                             "capacity_left",
                                             "capacity_right"))
def distributed_join_fk(lkey: U64, left_cols: tuple, rkey: U64,
                        right_cols: tuple, mesh: Mesh,
                        samples_per_dev: int = 128,
                        capacity_factor: float = 2.0,
                        capacity_factor_right: float | None = None,
                        capacity_left: int | None = None,
                        capacity_right: int | None = None):
    """FK equi-join of mesh-sharded tables.

    Args:
      lkey/rkey: U64 keys, globally (n_l,)/(n_r,), sharded over the mesh.
      left_cols/right_cols: tuples of u32 value columns, sharded likewise.
      capacity_left/right: explicit off-diagonal bucket capacities (e.g.
        from plan_join_capacity — demand-sized); override the factors.
    Returns (global_left_index, matched, pad_flag, out_left_cols,
    out_right_cols, overflow), each per-shard padded; rows with pad_flag==0
    are real, identified by global_left_index.
    """
    n_dev = mesh.shape[AXIS]
    n_l, n_r = lkey.lo.shape[0], rkey.lo.shape[0]
    assert n_l % n_dev == 0 and n_r % n_dev == 0
    # global left indices travel as u32
    assert n_l < (1 << 32), n_l
    # Splitters balance the UNION of both key distributions, so the side
    # with less mass can legitimately concentrate (e.g. a small dimension
    # table whose key range covers a fraction of the union quantiles) —
    # give it its own factor, up to n_dev for full concentration, or
    # plan_join_capacity for the measured demand. Diagonal (stay-local)
    # rows are free (tpu_qe.exchange.shuffle two-tier model).
    cf_r = capacity_factor if capacity_factor_right is None else capacity_factor_right
    cap_l = (capacity_left if capacity_left is not None
             else max(int(np.ceil(capacity_factor * (n_l // n_dev) / n_dev)), 16))
    cap_r = (capacity_right if capacity_right is not None
             else max(int(np.ceil(cf_r * (n_r // n_dev) / n_dev)), 16))

    spec = P(AXIS)
    n_out = 3 + len(left_cols) + len(right_cols) + 1
    fn = shard_map(
        lambda llo, lhi, lvs, rlo, rhi, rvs: _djoin_shard(
            llo, lhi, lvs, rlo, rhi, rvs, n_dev=n_dev,
            samples_per_dev=samples_per_dev, cap_l=cap_l, cap_r=cap_r),
        mesh=mesh,
        in_specs=(spec, spec, tuple([spec] * len(left_cols)),
                  spec, spec, tuple([spec] * len(right_cols))),
        out_specs=tuple([spec] * n_out),
        check_vma=False,
    )
    return fn(lkey.lo, lkey.hi, tuple(left_cols), rkey.lo, rkey.hi,
              tuple(right_cols))


def distributed_join_fk_numpy(lkeys, lvals, rkeys, rvals, mesh, **kw):
    """Host wrapper: returns (matched, right-values) in original left order.

    capacity_factor="auto" plans both exchanges first (plan_join_capacity)
    and sizes the receive layouts to measured off-diagonal demand.
    """
    n_dev = mesh.shape[AXIS]
    sh = NamedSharding(mesh, P(AXIS))

    def put64(x):
        u = U64.from_numpy(x)
        return U64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))

    def put32(x):
        return jax.device_put(jnp.asarray(x, dtype=jnp.uint32), sh)

    lk, rk = put64(lkeys), put64(rkeys)
    kw = _auto_capacity(kw, mesh, plan_join_capacity, (lk, rk),
                        ("capacity_left", "capacity_right"))
    res = distributed_join_fk(lk, tuple(put32(v) for v in lvals),
                              rk, tuple(put32(v) for v in rvals),
                              mesh=mesh, **kw)
    overflow = int(np.asarray(res[-1]).max())
    if overflow:
        raise RuntimeError("exchange capacity overflow; raise capacity_factor")
    g = np.asarray(res[0])
    matched = np.asarray(res[1]) > 0
    flag = np.asarray(res[2])
    rcols = [np.asarray(c) for c in res[3 + len(lvals):-1]]
    real = flag == 0
    n_l = len(lkeys)
    out_matched = np.zeros(n_l, dtype=bool)
    out_rvals = [np.zeros(n_l, dtype=np.uint32) for _ in rcols]
    gi = g[real]
    out_matched[gi] = matched[real]
    for o, c in zip(out_rvals, rcols):
        o[gi] = c[real]
    return out_matched, out_rvals


# --------------------------------------------------------------------------
# distributed one-to-many inner join
# --------------------------------------------------------------------------

def _djoin_inner_shard(llo, lhi, lval_cols, rlo, rhi, rval_cols, *, n_dev,
                       samples_per_dev, cap_l, cap_r, out_budget):
    from tpu_qe.ops.join import join_inner_padded

    n_local_l = llo.shape[0]
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    gidx = my * jnp.uint32(n_local_l) + jnp.arange(n_local_l,
                                                   dtype=jnp.uint32)
    # BARE-key splitters over the union: a one-to-many join must co-locate
    # ALL duplicates of a key (left and right) on one device, so hot keys
    # cannot be position-split here; a hot key's whole match set lands on
    # one shard (its output is quadratic in the duplicate count anyway) —
    # capacity/budget overflow stays exactly detected.
    sp_lo, sp_hi = sample_splitters(jnp.concatenate([rlo, llo]),
                                    jnp.concatenate([rhi, lhi]),
                                    n_dev, samples_per_dev)
    dest_l = route_by_splitters(llo, lhi, sp_lo, sp_hi)
    dest_r = route_by_splitters(rlo, rhi, sp_lo, sp_hi)

    recv_l, flag_l, _, _, ovf_l = exchange(
        dest_l, [llo, lhi, gidx] + list(lval_cols),
        [_ONES, _ONES, _ONES] + [jnp.uint32(0)] * len(lval_cols),
        n_dev, cap_l)
    recv_r, flag_r, _, _, ovf_r = exchange(
        dest_r, [rlo, rhi] + list(rval_cols),
        [_ONES, _ONES] + [jnp.uint32(0)] * len(rval_cols), n_dev, cap_r)

    left = Table({"_g": recv_l[2],
                  **{f"_l{i}": c for i, c in enumerate(recv_l[3:])}})
    right = Table({f"_r{i}": c for i, c in enumerate(recv_r[2:])})
    res = join_inner_padded(left, right,
                            U64(recv_l[0], recv_l[1]),
                            U64(recv_r[0], recv_r[1]),
                            flag_l == 0, flag_r == 0, out_budget)
    overflow = (ovf_l | ovf_r | res.overflow).reshape(1)
    outs = [res.table["_g"]]
    outs += [res.table[f"_l{i}"] for i in range(len(lval_cols))]
    outs += [res.table[f"_r{i}"] for i in range(len(rval_cols))]
    return (*outs, res.num_out.reshape(1), overflow)


def _djoin_inner_plan_shard(llo, lhi, rlo, rhi, *, n_dev, samples_per_dev):
    """Planning pass for the inner join: bare-key union splitters, both
    sides routed exactly like _djoin_inner_shard."""
    from tpu_qe.exchange.shuffle import offdiag_demand

    sp_lo, sp_hi = sample_splitters(jnp.concatenate([rlo, llo]),
                                    jnp.concatenate([rhi, lhi]),
                                    n_dev, samples_per_dev)
    dest_l = route_by_splitters(llo, lhi, sp_lo, sp_hi)
    dest_r = route_by_splitters(rlo, rhi, sp_lo, sp_hi)
    return (offdiag_demand(dest_l, n_dev).reshape(1),
            offdiag_demand(dest_r, n_dev).reshape(1))


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev"))
def plan_join_inner_capacity(lkey: U64, rkey: U64, mesh: Mesh,
                             samples_per_dev: int = 128):
    """Measured off-diagonal exchange demand (left, right) for the inner
    join. The OUTPUT budget stays a factor (match counts are data-
    dependent and overflow-detected exactly)."""
    n_dev = mesh.shape[AXIS]
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_djoin_inner_plan_shard, n_dev=n_dev,
                          samples_per_dev=samples_per_dev),
        mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec, spec),
        check_vma=False)
    return fn(lkey.lo, lkey.hi, rkey.lo, rkey.hi)


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev",
                                             "capacity_factor",
                                             "capacity_factor_right",
                                             "out_budget_factor",
                                             "capacity_left",
                                             "capacity_right"))
def distributed_join_inner(lkey: U64, left_cols: tuple, rkey: U64,
                           right_cols: tuple, mesh: Mesh,
                           samples_per_dev: int = 128,
                           capacity_factor: float = 2.0,
                           capacity_factor_right: float | None = None,
                           out_budget_factor: float = 4.0,
                           capacity_left: int | None = None,
                           capacity_right: int | None = None):
    """One-to-many inner equi-join of mesh-sharded tables.

    Both sides route by the same bare-key splitters so equal keys
    co-locate; each shard materializes its local matches into a padded
    budget of out_budget_factor * n_l_local rows. Returns per-shard
    (global_left_index, left value cols, right value cols, num_out,
    overflow); slots [0, num_out[d]) of shard d are real.
    """
    n_dev = mesh.shape[AXIS]
    n_l, n_r = lkey.lo.shape[0], rkey.lo.shape[0]
    assert n_l % n_dev == 0 and n_r % n_dev == 0
    assert n_l < (1 << 32), n_l
    cf_r = (capacity_factor if capacity_factor_right is None
            else capacity_factor_right)
    cap_l = (capacity_left if capacity_left is not None
             else max(int(np.ceil(capacity_factor * (n_l // n_dev)
                                  / n_dev)), 16))
    cap_r = (capacity_right if capacity_right is not None
             else max(int(np.ceil(cf_r * (n_r // n_dev) / n_dev)), 16))
    out_budget = max(int(np.ceil(out_budget_factor * (n_l // n_dev))), 16)
    spec = P(AXIS)
    n_out = 1 + len(left_cols) + len(right_cols) + 2
    fn = shard_map(
        lambda llo, lhi, lvs, rlo, rhi, rvs: _djoin_inner_shard(
            llo, lhi, lvs, rlo, rhi, rvs, n_dev=n_dev,
            samples_per_dev=samples_per_dev, cap_l=cap_l, cap_r=cap_r,
            out_budget=out_budget),
        mesh=mesh,
        in_specs=(spec, spec, tuple([spec] * len(left_cols)),
                  spec, spec, tuple([spec] * len(right_cols))),
        out_specs=tuple([spec] * n_out),
        check_vma=False,
    )
    return fn(lkey.lo, lkey.hi, tuple(left_cols), rkey.lo, rkey.hi,
              tuple(right_cols))


def distributed_join_inner_numpy(lkeys, lvals, rkeys, rvals, mesh, **kw):
    """Host wrapper: returns (left_index, left value cols, right value
    cols) over all real output rows, in no particular global order.

    capacity_factor="auto" plans both exchanges (plan_join_inner_capacity)
    and sizes the receive layouts to measured off-diagonal demand; the
    output budget stays out_budget_factor (exact overflow detection)."""
    n_dev = mesh.shape[AXIS]
    sh = NamedSharding(mesh, P(AXIS))

    def put64(x):
        u = U64.from_numpy(x)
        return U64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))

    def put32(x):
        return jax.device_put(jnp.asarray(x, dtype=jnp.uint32), sh)

    lk, rk = put64(lkeys), put64(rkeys)
    kw = _auto_capacity(kw, mesh, plan_join_inner_capacity, (lk, rk),
                        ("capacity_left", "capacity_right"))
    res = distributed_join_inner(
        lk, tuple(put32(v) for v in lvals),
        rk, tuple(put32(v) for v in rvals), mesh=mesh, **kw)
    if int(np.asarray(res[-1]).max()):
        raise RuntimeError(
            "exchange capacity or output budget overflow; raise "
            "capacity_factor / out_budget_factor")
    num_out = np.asarray(res[-2]).reshape(n_dev)
    cols = [np.asarray(c).reshape(n_dev, -1) for c in res[:-2]]
    picks = [np.concatenate([c[d, :num_out[d]] for d in range(n_dev)])
             for c in cols]
    g = picks[0]
    lcols = picks[1:1 + len(lvals)]
    rcols = picks[1 + len(lvals):]
    return g, lcols, rcols


# --------------------------------------------------------------------------
# distributed outer join (LEFT / FULL)
# --------------------------------------------------------------------------

def _djoin_outer_shard(llo, lhi, lval_cols, rlo, rhi, rval_cols, *,
                       n_dev, samples_per_dev, cap_l, cap_r, out_budget,
                       full):
    """The inner-join shard prelude (bare-key union splitters — ALL
    copies of a key co-locate, so each shard's local outer verdict is
    globally exact) + join_outer_padded as the local body."""
    from tpu_qe.ops.join import join_outer_padded

    n_local_l = llo.shape[0]
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    gidx = my * jnp.uint32(n_local_l) + jnp.arange(n_local_l,
                                                   dtype=jnp.uint32)
    sp_lo, sp_hi = sample_splitters(jnp.concatenate([rlo, llo]),
                                    jnp.concatenate([rhi, lhi]),
                                    n_dev, samples_per_dev)
    dest_l = route_by_splitters(llo, lhi, sp_lo, sp_hi)
    dest_r = route_by_splitters(rlo, rhi, sp_lo, sp_hi)
    recv_l, flag_l, _, _, ovf_l = exchange(
        dest_l, [llo, lhi, gidx] + list(lval_cols),
        [_ONES, _ONES, _ONES] + [jnp.uint32(0)] * len(lval_cols),
        n_dev, cap_l)
    recv_r, flag_r, _, _, ovf_r = exchange(
        dest_r, [rlo, rhi] + list(rval_cols),
        [_ONES, _ONES] + [jnp.uint32(0)] * len(rval_cols), n_dev, cap_r)
    left = Table({"_g": recv_l[2],
                  **{f"_l{i}": c for i, c in enumerate(recv_l[3:])}})
    right = Table({f"_r{i}": c for i, c in enumerate(recv_r[2:])})
    res = join_outer_padded(left, right,
                            U64(recv_l[0], recv_l[1]),
                            U64(recv_r[0], recv_r[1]),
                            flag_l == 0, flag_r == 0, out_budget,
                            full=full)
    overflow = (ovf_l | ovf_r | res.overflow).reshape(1)
    outs = [res.table["_g"]]
    outs += [res.table[f"_l{i}"] for i in range(len(lval_cols))]
    outs += [res.table[f"_r{i}"] for i in range(len(rval_cols))]
    outs.append(res.matched.astype(jnp.uint32))
    outs += [res.num_out.reshape(1), overflow]
    if full:
        ro = res.right_only
        outs += [ro["_key"].lo, ro["_key"].hi]
        outs += [ro[f"_r{i}"] for i in range(len(rval_cols))]
        outs.append(res.num_right_only.reshape(1))
    return tuple(outs)


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev",
                                             "capacity_factor",
                                             "capacity_factor_right",
                                             "out_budget_factor",
                                             "capacity_left",
                                             "capacity_right", "full"))
def distributed_join_outer(lkey: U64, left_cols: tuple, rkey: U64,
                           right_cols: tuple, mesh: Mesh,
                           samples_per_dev: int = 128,
                           capacity_factor: float = 2.0,
                           capacity_factor_right: float | None = None,
                           out_budget_factor: float = 4.0,
                           capacity_left: int | None = None,
                           capacity_right: int | None = None,
                           full: bool = False):
    """One-to-many LEFT (or FULL) OUTER equi-join of mesh-sharded
    tables: the inner join's co-location exchange + a per-shard padded
    outer join (unmatched left rows keep one NULL-right slot; FULL adds
    each shard's unmatched right rows — globally exact because all
    copies of a key land on one device). Returns per-shard
    (global_left_index, left cols, right cols, matched, num_out,
    overflow[, ro_key_lo, ro_key_hi, ro right cols, num_right_only])."""
    n_dev = mesh.shape[AXIS]
    n_l, n_r = lkey.lo.shape[0], rkey.lo.shape[0]
    assert n_l % n_dev == 0 and n_r % n_dev == 0
    assert n_l < (1 << 32), n_l
    cf_r = (capacity_factor if capacity_factor_right is None
            else capacity_factor_right)
    cap_l = (capacity_left if capacity_left is not None
             else max(int(np.ceil(capacity_factor * (n_l // n_dev)
                                  / n_dev)), 16))
    cap_r = (capacity_right if capacity_right is not None
             else max(int(np.ceil(cf_r * (n_r // n_dev) / n_dev)), 16))
    out_budget = max(int(np.ceil(out_budget_factor * (n_l // n_dev))), 16)
    spec = P(AXIS)
    n_out = 1 + len(left_cols) + len(right_cols) + 3
    if full:
        n_out += 2 + len(right_cols) + 1
    fn = shard_map(
        lambda llo, lhi, lvs, rlo, rhi, rvs: _djoin_outer_shard(
            llo, lhi, lvs, rlo, rhi, rvs, n_dev=n_dev,
            samples_per_dev=samples_per_dev, cap_l=cap_l, cap_r=cap_r,
            out_budget=out_budget, full=full),
        mesh=mesh,
        in_specs=(spec, spec, tuple([spec] * len(left_cols)),
                  spec, spec, tuple([spec] * len(right_cols))),
        out_specs=tuple([spec] * n_out),
        check_vma=False,
    )
    return fn(lkey.lo, lkey.hi, tuple(left_cols), rkey.lo, rkey.hi,
              tuple(right_cols))


def distributed_join_outer_numpy(lkeys, lvals, rkeys, rvals, mesh,
                                 full=False, **kw):
    """Host wrapper: (left_index, left cols, right cols, matched) over
    all real outer-join rows (no particular global order), plus
    (ro_keys, ro cols) when full=True. capacity_factor="auto" plans the
    exchanges exactly like the inner join."""
    n_dev = mesh.shape[AXIS]
    sh = NamedSharding(mesh, P(AXIS))

    def put64(x):
        u = U64.from_numpy(x)
        return U64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))

    def put32(x):
        return jax.device_put(jnp.asarray(x, dtype=jnp.uint32), sh)

    lk, rk = put64(lkeys), put64(rkeys)
    kw = _auto_capacity(kw, mesh, plan_join_inner_capacity, (lk, rk),
                        ("capacity_left", "capacity_right"))
    res = distributed_join_outer(
        lk, tuple(put32(v) for v in lvals),
        rk, tuple(put32(v) for v in rvals), mesh=mesh, full=full, **kw)
    n_main = 1 + len(lvals) + len(rvals) + 1
    num_out = np.asarray(res[n_main]).reshape(n_dev)
    ovf = np.asarray(res[n_main + 1])
    if int(ovf.max()):
        raise RuntimeError(
            "exchange capacity or output budget overflow; raise "
            "capacity_factor / out_budget_factor")
    cols = [np.asarray(c).reshape(n_dev, -1) for c in res[:n_main]]
    picks = [np.concatenate([c[d, :num_out[d]] for d in range(n_dev)])
             for c in cols]
    g = picks[0]
    lcols = picks[1:1 + len(lvals)]
    rcols = picks[1 + len(lvals):1 + len(lvals) + len(rvals)]
    matched = picks[-1].astype(bool)
    if not full:
        return g, lcols, rcols, matched
    ro = res[n_main + 2:]
    n_ro = np.asarray(ro[-1]).reshape(n_dev)
    ro_cols = [np.asarray(c).reshape(n_dev, -1) for c in ro[:-1]]
    ro_picks = [np.concatenate([c[d, :n_ro[d]] for d in range(n_dev)])
                for c in ro_cols]
    ro_keys = (ro_picks[0].astype(np.uint64)
               | (ro_picks[1].astype(np.uint64) << np.uint64(32)))
    return g, lcols, rcols, matched, ro_keys, ro_picks[2:]


# --------------------------------------------------------------------------
# distributed top-k
# --------------------------------------------------------------------------

def _dtopk_shard(lo, hi, *cols, n_dev, k, largest):
    """Local top-k per shard, then all_gather the k*D candidate rows and
    reduce — communication is k*D rows (tiny), no keyed exchange needed.
    Global original order rides along as the tiebreak so the result is
    bit-identical to a single-machine stable top-k."""
    n_local = lo.shape[0]
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    gidx = my * jnp.uint32(n_local) + jnp.arange(n_local, dtype=jnp.uint32)
    wlo = ~lo if largest else lo
    whi = ~hi if largest else hi
    res = jax.lax.sort([whi, wlo, gidx] + list(cols), num_keys=3,
                       is_stable=False)
    kk = min(k, n_local)  # a shard can contribute at most all its rows
    cand = [r[:kk] for r in res]  # local best (sorted)
    g = [jax.lax.all_gather(c, AXIS).reshape(-1) for c in cand]
    res2 = jax.lax.sort(g, num_keys=3, is_stable=False)
    out = [r[:k] for r in res2]
    o_lo = ~out[1] if largest else out[1]
    o_hi = ~out[0] if largest else out[0]
    return (o_lo, o_hi, out[2], *out[3:])


@functools.partial(jax.jit, static_argnames=("mesh", "k", "largest"))
def distributed_top_k(key: U64, cols: tuple, mesh: Mesh, k: int,
                      largest: bool = False):
    """k globally best rows of a mesh-sharded table, replicated on every
    device. Returns (lo, hi, global_row_index, *value cols), best first;
    ties break by global original row order (bit-identical to the
    single-chip ops.topk result)."""
    n_dev = mesh.shape[AXIS]
    n = key.lo.shape[0]
    assert n % n_dev == 0 and n < (1 << 32)
    assert 0 < k <= n, (k, n)
    spec = P(AXIS)
    rep = P()
    fn = shard_map(
        functools.partial(_dtopk_shard, n_dev=n_dev, k=k, largest=largest),
        mesh=mesh,
        in_specs=tuple([spec] * (2 + len(cols))),
        out_specs=tuple([rep] * (3 + len(cols))),
        check_vma=False,
    )
    return fn(key.lo, key.hi, *cols)


def distributed_top_k_numpy(keys, vals, mesh, k, largest=False):
    """Host wrapper: (keys_k, global_indices_k, value_cols_k)."""
    sh = NamedSharding(mesh, P(AXIS))
    u = U64.from_numpy(keys)
    key = U64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))
    cols = tuple(jax.device_put(jnp.asarray(v, dtype=jnp.uint32), sh)
                 for v in vals)
    out = distributed_top_k(key, cols, mesh=mesh, k=k, largest=largest)
    lo, hi, g = (np.asarray(out[0]), np.asarray(out[1]), np.asarray(out[2]))
    ks = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return ks, g, [np.asarray(c) for c in out[3:]]


# --------------------------------------------------------------------------
# distributed GROUP BY aggregate
# --------------------------------------------------------------------------

def _neutral(agg: str, dtype) -> jnp.ndarray:
    """Padding-slot value whose contribution is a no-op for the combine,
    as a u32 bit pattern (exchange columns are u32)."""
    if dtype == jnp.float32:
        v = {"count": 0.0, "sum": 0.0, "min": float("inf"),
             "max": float("-inf")}[agg]
        return jnp.float32(v).view(jnp.uint32)
    return jnp.uint32({"count": 0, "sum": 0, "min": 0xFFFFFFFF,
                       "max": 0}[agg])


def _dagg_shard(lo, hi, val, *, n_dev, samples_per_dev, capacity,
                inner_aggs):
    from tpu_qe.ops.aggregate import group_aggregate

    # Phase 1: local partial aggregation (volume reduction). Results are
    # padded to n_local with key=all-ones; their agg payloads are set to
    # the agg's neutral element so later combining ignores them.
    # 'count' is ALWAYS among inner_aggs (appended by the caller if not
    # requested): the host wrapper needs it to distinguish a purely-padding
    # group from a real all-ones key group.
    part = group_aggregate(U64(lo, hi), val, aggs=inner_aggs)
    return _partials_to_global(part, val.dtype, n_dev=n_dev,
                               samples_per_dev=samples_per_dev,
                               capacity=capacity, inner_aggs=inner_aggs)


def _partials_to_global(part, val_dtype, *, n_dev, samples_per_dev,
                        capacity, inner_aggs):
    """Phases 2-3 of two-phase aggregation over a per-shard padded
    partial GroupResult: shuffle partial groups by key splitters, merge
    received partials per key. Shared by _dagg_shard and the fused
    join->GROUP BY shard (whose phase 1 is group_aggregate_sorted over
    the join stream)."""
    idx = jnp.arange(part.key.lo.shape[0], dtype=jnp.uint32)
    is_real = idx < part.num_groups
    klo = jnp.where(is_real, part.key.lo, _ONES)
    khi = jnp.where(is_real, part.key.hi, _ONES)
    # per-agg value dtypes (count is always u32; sum/min/max follow val)
    dtypes = {a: (jnp.uint32 if a == "count" else val_dtype)
              for a in inner_aggs}
    is_int_sum = val_dtype != jnp.float32
    # flattened exchange planes: an integer sum is an exact u64 U64 pair
    # (two u32 planes, neutral 0/0); everything else is one plane
    partials = []
    pad_vals = []
    plane_spec = []  # (agg, number of planes)
    for a in inner_aggs:
        col = part.aggs[a]
        if a == "sum" and is_int_sum:
            planes = [col.lo, col.hi]
            neutrals = [jnp.uint32(0), jnp.uint32(0)]
        else:
            bits = col.view(jnp.uint32) if col.dtype != jnp.uint32 else col
            planes = [bits]
            neutrals = [_neutral(a, dtypes[a])]
        plane_spec.append((a, len(planes)))
        for p, nv in zip(planes, neutrals):
            partials.append(jnp.where(is_real, p, nv))
            pad_vals.append(nv)

    # Phase 2: shuffle partial groups by key. Padding slots carry neutral
    # values and route to their OWN device: the two-tier exchange keeps
    # diagonal rows out of the all_to_all entirely, so pads cost zero
    # interconnect AND zero off-diagonal capacity (the earlier round-robin
    # spread moved ~n_local pad rows across the wire per shard and made
    # off-diagonal demand pad-dominated — letting them all route to the
    # top device would have overflowed its capacity instead).
    # Sample only the REAL group prefix ([0, num_groups)) — a strided
    # sample over the padded array would be dominated by all-ones pads
    # whenever groups are few, collapsing every real group onto device 0.
    sp_lo, sp_hi = sample_splitters(klo, khi, n_dev, samples_per_dev,
                                    n_valid=part.num_groups)
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    dest = route_by_splitters(klo, khi, sp_lo, sp_hi)
    dest = jnp.where(is_real, dest, my)
    pads = [_ONES, _ONES] + pad_vals
    recv, _, _, _, overflow = exchange(dest, [klo, khi] + partials, pads,
                                       n_dev, capacity)

    # Phase 3: combine received partials per key with ONE key sort shared
    # across all agg columns (count/sum by inclusive segmented sums read
    # at group ends — integer sums as carried u64 pairs; min/max by an
    # inclusive segmented scan read at ends), then one packed-position
    # compaction — two sorts total instead of two per agg. All segmented
    # scans are the blocked formulation of ops/segscan.py.
    from tpu_qe.ops.aggregate import (_shift_right_one, segmented_reduce,
                                      segmented_sum_u64)

    rklo, rkhi = recv[0], recv[1]
    m = rklo.shape[0]
    assert m < (1 << 31), m
    res = jax.lax.sort([rkhi, rklo] + list(recv[2:]), num_keys=2,
                       is_stable=False)
    skhi, sklo = res[0], res[1]
    scols = list(res[2:])
    pos = jnp.arange(m, dtype=jnp.uint32)
    is_new = ((pos == 0) | (sklo != _shift_right_one(sklo, 0))
              | (skhi != _shift_right_one(skhi, 0)))
    is_end = jnp.concatenate([is_new[1:], jnp.ones((1,), bool)])
    num_groups_all = jnp.sum(is_end.astype(jnp.uint32))

    reduced = []
    j = 0
    for a, n_planes in plane_spec:
        if a == "sum" and is_int_sum:
            rl, rh = segmented_sum_u64(scols[j], scols[j + 1], is_new)
            reduced += [rl, rh]
            j += 2
            continue
        dt = dtypes[a]
        v = scols[j].view(dt) if dt != jnp.uint32 else scols[j]
        j += 1
        kind = "sum" if a == "count" else a
        r = segmented_reduce(v, is_new, kind)
        reduced.append(r.view(jnp.uint32) if r.dtype != jnp.uint32 else r)

    # compact group-end rows to the front (keep/drop packed over position)
    packed = jnp.where(is_end, pos, pos | jnp.uint32(1 << 31))
    ops2 = [packed, sklo, skhi] + [
        (r.view(jnp.uint32) if r.dtype != jnp.uint32 else r)
        for r in reduced]
    res2 = jax.lax.sort(ops2, num_keys=1, is_stable=False)
    out_lo, out_hi = res2[1], res2[2]
    out_aggs = list(res2[3:])
    return (out_lo, out_hi, *out_aggs,
            num_groups_all.reshape(1), overflow.reshape(1))


def _dagg_plan_shard(lo, hi, *, n_dev, samples_per_dev):
    """Planning pass for the aggregate exchange: run phase 1 on keys only
    and route the partial groups EXACTLY like _dagg_shard (same
    group_aggregate key stream, same splitter sampling over the real
    prefix, pads to own device), returning the max off-diagonal bucket.
    Only real partial groups crossing devices count — the demand is the
    post-reduction group traffic, usually tiny next to n_local."""
    from tpu_qe.exchange.shuffle import offdiag_demand
    from tpu_qe.ops.aggregate import group_aggregate

    part = group_aggregate(U64(lo, hi), aggs=("count",))
    idx = jnp.arange(part.key.lo.shape[0], dtype=jnp.uint32)
    is_real = idx < part.num_groups
    klo = jnp.where(is_real, part.key.lo, _ONES)
    khi = jnp.where(is_real, part.key.hi, _ONES)
    sp_lo, sp_hi = sample_splitters(klo, khi, n_dev, samples_per_dev,
                                    n_valid=part.num_groups)
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    dest = route_by_splitters(klo, khi, sp_lo, sp_hi)
    dest = jnp.where(is_real, dest, my)
    return offdiag_demand(dest, n_dev).reshape(1)


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev"))
def plan_aggregate_capacity(key: U64, mesh: Mesh,
                            samples_per_dev: int = 128):
    """Measured off-diagonal partial-group exchange demand for
    distributed_aggregate (plan-then-execute, like sort/join)."""
    n_dev = mesh.shape[AXIS]
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_dagg_plan_shard, n_dev=n_dev,
                          samples_per_dev=samples_per_dev),
        mesh=mesh, in_specs=(spec, spec), out_specs=spec, check_vma=False)
    return fn(key.lo, key.hi)


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev",
                                             "capacity_factor", "aggs",
                                             "capacity"))
def distributed_aggregate(key: U64, value: jnp.ndarray, mesh: Mesh,
                          aggs=("count", "sum"), samples_per_dev: int = 128,
                          capacity_factor: float = 2.0,
                          capacity: int | None = None):
    """GROUP BY over mesh-sharded rows (two-phase aggregation).

    Returns (klo, khi, *agg_columns_in_inner_order, num_groups, overflow)
    where inner order = requested aggs plus a trailing 'count' if it was
    not requested (used to identify padding groups). An integer "sum"
    contributes TWO u32 columns (lo, hi) — the exact u64 pair sum.

    capacity: explicit off-diagonal partial-group bucket capacity (e.g.
    from plan_aggregate_capacity — demand-sized); overrides
    capacity_factor. Pads never consume it (they stay on the diagonal).
    """
    n_dev = mesh.shape[AXIS]
    n = key.lo.shape[0]
    assert n % n_dev == 0
    inner_aggs = tuple(aggs) if "count" in aggs else tuple(aggs) + ("count",)
    if capacity is None:
        capacity = max(int(np.ceil(capacity_factor * (n // n_dev) / n_dev)),
                       16)
    capacity = max(capacity, 16)
    spec = P(AXIS)
    is_int_sum = value.dtype != jnp.float32
    n_agg_cols = sum(2 if (a == "sum" and is_int_sum) else 1
                     for a in inner_aggs)
    n_out = 2 + n_agg_cols + 2
    fn = shard_map(
        functools.partial(_dagg_shard, n_dev=n_dev,
                          samples_per_dev=samples_per_dev,
                          capacity=capacity, inner_aggs=inner_aggs),
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=tuple([spec] * n_out),
        check_vma=False,
    )
    return fn(key.lo, key.hi, value)


def distributed_aggregate_numpy(keys, values, mesh, aggs=("count", "sum"),
                                **kw):
    """Host wrapper: returns {key -> {agg -> value}} over all shards.

    Integer sums are EXACT (u64 pair-summed end to end — no mod-2^32
    truncation); min/max aggregate u32 bit patterns; float32 values
    aggregate as floats.

    capacity_factor="auto" plans the partial-group exchange first
    (plan_aggregate_capacity) and sizes the receive layout to measured
    off-diagonal demand — no n_dev-factor guess needed even when every
    row shares one key (the plan measures the post-reduction traffic).
    """
    sh = NamedSharding(mesh, P(AXIS))
    u = U64.from_numpy(keys)
    key = U64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))
    kw = _auto_capacity(kw, mesh, plan_aggregate_capacity, (key,),
                        ("capacity",))
    values = np.asarray(values)
    if values.dtype == np.float32:
        val = jax.device_put(jnp.asarray(values), sh)
    else:
        # u32 wraparound reinterpretation is exact for sum/count, but
        # min/max of a signed column with negatives would be computed in
        # UNSIGNED order (min([-1, 5]) -> 5). Reject rather than be wrong.
        if (np.issubdtype(values.dtype, np.signedinteger)
                and ({"min", "max"} & set(aggs)) and bool((values < 0).any())):
            raise ValueError(
                "min/max over signed values with negatives would aggregate "
                "in unsigned order; bias-map to sortable u32 first "
                "(v.astype(np.int64) + 2**31 -> uint32) and invert on output")
        val = jax.device_put(jnp.asarray(values.astype(np.uint32)), sh)
    res = distributed_aggregate(key, val, mesh=mesh, aggs=tuple(aggs), **kw)
    if int(np.asarray(res[-1]).max()):
        raise RuntimeError("exchange capacity overflow; raise capacity_factor")
    n_dev = mesh.shape[AXIS]
    klo = np.asarray(res[0]).reshape(n_dev, -1)
    khi = np.asarray(res[1]).reshape(n_dev, -1)
    inner = tuple(aggs) if "count" in aggs else tuple(aggs) + ("count",)
    is_f32 = values.dtype == np.float32
    cols = []
    res_cols = res[2:-2]
    j = 0
    for a in inner:
        if a == "sum" and not is_f32:
            lo_c = np.asarray(res_cols[j]).reshape(n_dev, -1)
            hi_c = np.asarray(res_cols[j + 1]).reshape(n_dev, -1)
            j += 2
            cols.append(lo_c.astype(np.uint64)
                        | (hi_c.astype(np.uint64) << np.uint64(32)))
            continue
        c = np.asarray(res_cols[j]).reshape(n_dev, -1)
        j += 1
        if is_f32 and a != "count":
            c = c.view(np.float32)
        cols.append(c)
    ng = np.asarray(res[-2]).reshape(n_dev)
    out = {}
    for d in range(n_dev):
        for i in range(int(ng[d])):
            k = int(klo[d, i]) | (int(khi[d, i]) << 32)
            row = {a: (float(c[d, i]) if is_f32 and a != "count"
                       else int(c[d, i]))
                   for a, c in zip(inner, cols)}
            if row["count"] == 0:
                continue  # purely-padding group
            out[k] = {a: row[a] for a in aggs}
    return out


# --------------------------------------------------------------------------
# distributed COUNT(DISTINCT value) GROUP BY key
# --------------------------------------------------------------------------

def _dcd_dedup_local(lo, hi, val):
    """Sort local rows by (key, value) and compact the distinct pairs to
    the front. Dedup IS the exchange-volume reducer here — the
    count_distinct analogue of distributed_aggregate's phase-1 partial
    aggregation (duplicates of a pair carry zero information downstream).
    Returns (klo, khi, v, m): the m distinct local pairs as a prefix."""
    from tpu_qe.ops.aggregate import _shift_right_one

    n = lo.shape[0]
    shi, slo, sv = jax.lax.sort([hi, lo, val], num_keys=3, is_stable=False)
    pos = jnp.arange(n, dtype=jnp.uint32)
    new = ((pos == 0) | (slo != _shift_right_one(slo, 0))
           | (shi != _shift_right_one(shi, 0))
           | (sv != _shift_right_one(sv, 0)))
    m = jnp.sum(new.astype(jnp.uint32))
    assert n < (1 << 31), n
    packed = jnp.where(new, pos, pos | jnp.uint32(1 << 31))
    _, clo, chi, cv = jax.lax.sort([packed, slo, shi, sv], num_keys=1,
                                   is_stable=False)
    return clo, chi, cv, m


def _dcd_route(lo, hi, val, *, n_dev, samples_per_dev):
    """Shared dedup + splitter routing of the execute and plan passes
    (identical routing is what makes the plan's demand exact)."""
    clo, chi, cv, m = _dcd_dedup_local(lo, hi, val)
    idx = jnp.arange(clo.shape[0], dtype=jnp.uint32)
    is_real = idx < m
    klo = jnp.where(is_real, clo, _ONES)
    khi = jnp.where(is_real, chi, _ONES)
    sp_lo, sp_hi = sample_splitters(klo, khi, n_dev, samples_per_dev,
                                    n_valid=m)
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    dest = route_by_splitters(klo, khi, sp_lo, sp_hi)
    dest = jnp.where(is_real, dest, my)
    return klo, khi, cv, is_real, dest


def _dcd_shard(lo, hi, val, *, n_dev, samples_per_dev, capacity):
    from tpu_qe.ops.aggregate import group_aggregate

    klo, khi, cv, is_real, dest = _dcd_route(
        lo, hi, val, n_dev=n_dev, samples_per_dev=samples_per_dev)
    # splitters route by KEY alone, so every pair of a key lands on ONE
    # device and the local count_distinct there is globally exact (pairs
    # arriving from different sources may still coincide — the local
    # (key, value) sort inside group_aggregate dedups across sources).
    # An explicit validity plane marks real slots: no neutral-element
    # trick exists for distinctness (a pad value would COUNT as a value),
    # and it keeps real all-ones keys exact.
    recv, _, _, _, overflow = exchange(
        dest,
        [klo, khi, jnp.where(is_real, cv, jnp.uint32(0)),
         is_real.astype(jnp.uint32)],
        [_ONES, _ONES, jnp.uint32(0), jnp.uint32(0)], n_dev, capacity)
    res = group_aggregate(U64(recv[0], recv[1]), recv[2],
                          aggs=("count_distinct",), valid=recv[3] > 0)
    return (res.key.lo, res.key.hi, res.aggs["count_distinct"],
            res.num_groups.reshape(1), overflow.reshape(1))


def _dcd_plan_shard(lo, hi, val, *, n_dev, samples_per_dev):
    from tpu_qe.exchange.shuffle import offdiag_demand

    _, _, _, _, dest = _dcd_route(lo, hi, val, n_dev=n_dev,
                                  samples_per_dev=samples_per_dev)
    return offdiag_demand(dest, n_dev).reshape(1)


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev"))
def plan_count_distinct_capacity(key: U64, value: jnp.ndarray, mesh: Mesh,
                                 samples_per_dev: int = 128):
    """Measured off-diagonal distinct-pair exchange demand for
    distributed_count_distinct (plan-then-execute)."""
    n_dev = mesh.shape[AXIS]
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_dcd_plan_shard, n_dev=n_dev,
                          samples_per_dev=samples_per_dev),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)
    return fn(key.lo, key.hi, value)


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev",
                                             "capacity_factor", "capacity"))
def distributed_count_distinct(key: U64, value: jnp.ndarray, mesh: Mesh,
                               samples_per_dev: int = 128,
                               capacity_factor: float = 2.0,
                               capacity: int | None = None):
    """SQL's COUNT(DISTINCT value) GROUP BY key over mesh-sharded rows.

    Two phases: (1) local (key, value) dedup per shard — the volume
    reducer; (2) route distinct pairs by key splitters and count pair
    runs per key locally (exact: a key's pairs all land on one device).
    Exchange volume is the number of locally-distinct pairs, not rows.

    Returns (klo, khi, count_distinct, num_groups, overflow), each
    mesh-sharded; the first num_groups[d] entries of device d's block are
    its groups (global key ranges are splitter-disjoint across devices).
    """
    n_dev = mesh.shape[AXIS]
    n = key.lo.shape[0]
    assert n % n_dev == 0
    if capacity is None:
        capacity = max(int(np.ceil(capacity_factor * (n // n_dev) / n_dev)),
                       16)
    capacity = max(capacity, 16)
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_dcd_shard, n_dev=n_dev,
                          samples_per_dev=samples_per_dev,
                          capacity=capacity),
        mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=tuple([spec] * 5), check_vma=False)
    return fn(key.lo, key.hi, value)


def distributed_count_distinct_numpy(keys, values, mesh, **kw):
    """Host wrapper: {key -> distinct-value count} over all shards.

    capacity_factor="auto" plans the distinct-pair exchange first and
    sizes the receive layout to measured off-diagonal demand."""
    sh = NamedSharding(mesh, P(AXIS))
    u = U64.from_numpy(keys)
    key = U64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))
    values = np.asarray(values)
    bits = values.view(np.uint32) if values.dtype != np.uint32 else values
    val = jax.device_put(jnp.asarray(bits), sh)
    kw = _auto_capacity(kw, mesh, plan_count_distinct_capacity, (key, val),
                        ("capacity",))
    res = distributed_count_distinct(key, val, mesh=mesh, **kw)
    if int(np.asarray(res[-1]).max()):
        raise RuntimeError("exchange capacity overflow; raise capacity_factor")
    n_dev = mesh.shape[AXIS]
    klo = np.asarray(res[0]).reshape(n_dev, -1)
    khi = np.asarray(res[1]).reshape(n_dev, -1)
    cd = np.asarray(res[2]).reshape(n_dev, -1)
    ng = np.asarray(res[3]).reshape(n_dev)
    out = {}
    for d in range(n_dev):
        for i in range(int(ng[d])):
            k = int(klo[d, i]) | (int(khi[d, i]) << 32)
            out[k] = int(cd[d, i])
    return out


# --------------------------------------------------------------------------
# fused distributed join -> GROUP BY (the key-sorted stream never lands)
# --------------------------------------------------------------------------

def _djoin_agg_shard(llo, lhi, rlo, rhi, rval, *, n_dev, samples_per_dev,
                     cap_l, cap_r, cap_agg, inner_aggs):
    from tpu_qe.ops.aggregate import group_aggregate_sorted
    from tpu_qe.ops.join import join_fk_scan

    (lkey, g, flag_l, _lv, rkey, r_valid, right_vals,
     ovf_j) = _djoin_exchange(llo, lhi, (), rlo, rhi, (rval,),
                              n_dev=n_dev,
                              samples_per_dev=samples_per_dev,
                              cap_l=cap_l, cap_r=cap_r)
    # the join's stream output is KEY-SORTED per shard: the aggregate's
    # phase-1 partial tables come from group_aggregate_sorted with no
    # extra key sort — the fusion saves the join restore sort AND the
    # aggregate's own key sort (same two-sorts-saved shape as the
    # in-core fused path, bench_join_agg), and the second exchange moves
    # partial GROUPS, not rows.
    st = join_fk_scan(Table({"_z": jnp.zeros_like(g)}),
                      Table({"_r0": right_vals[0]}), lkey, rkey,
                      output="stream", l_valid=flag_l == 0,
                      r_valid=r_valid)
    part = group_aggregate_sorted(st.key, st.values["_r0"],
                                  aggs=inner_aggs, valid=st.matched)
    out = _partials_to_global(part, rval.dtype, n_dev=n_dev,
                              samples_per_dev=samples_per_dev,
                              capacity=cap_agg, inner_aggs=inner_aggs)
    lo, hi, *rest = out
    ng, ovf_a = rest[-2], rest[-1]
    return (lo, hi, *rest[:-2], ng, jnp.maximum(ovf_j, ovf_a))


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev",
                                             "aggs", "capacity_factor",
                                             "capacity_left",
                                             "capacity_right",
                                             "capacity_agg"))
def distributed_join_aggregate(lkey: U64, rkey: U64, rvalue: jnp.ndarray,
                               mesh: Mesh, aggs=("count", "sum"),
                               samples_per_dev: int = 128,
                               capacity_factor: float = 2.0,
                               capacity_left: int | None = None,
                               capacity_right: int | None = None,
                               capacity_agg: int | None = None):
    """SELECT l.key, aggs(r.value) FROM l JOIN r USING (key) GROUP BY
    l.key over mesh-sharded sides, FUSED: one join co-location exchange,
    per-shard stream join + sorted-stream partial aggregation, one
    partial-GROUP exchange — the joined rows are never materialized,
    restored, or re-shuffled. Returns the distributed_aggregate output
    contract (klo, khi, *agg cols incl. trailing count, num_groups,
    overflow)."""
    n_dev = mesh.shape[AXIS]
    n_l, n_r = lkey.lo.shape[0], rkey.lo.shape[0]
    assert n_l % n_dev == 0 and n_r % n_dev == 0
    inner_aggs = tuple(aggs) if "count" in aggs else tuple(aggs) + ("count",)

    def cap(c, n):
        if c is not None:
            return max(c, 16)
        return max(int(np.ceil(capacity_factor * (n // n_dev) / n_dev)), 16)

    is_int_sum = rvalue.dtype != jnp.float32
    n_agg_cols = sum(2 if (a == "sum" and is_int_sum) else 1
                     for a in inner_aggs)
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_djoin_agg_shard, n_dev=n_dev,
                          samples_per_dev=samples_per_dev,
                          cap_l=cap(capacity_left, n_l),
                          cap_r=cap(capacity_right, n_r),
                          cap_agg=cap(capacity_agg, n_l),
                          inner_aggs=inner_aggs),
        mesh=mesh, in_specs=(spec,) * 5,
        out_specs=tuple([spec] * (2 + n_agg_cols + 2)), check_vma=False)
    return fn(lkey.lo, lkey.hi, rkey.lo, rkey.hi, rvalue)


def distributed_join_aggregate_numpy(lkeys, rkeys, rvals, mesh,
                                     aggs=("count", "sum"), **kw):
    """Host wrapper: {left key -> {agg -> value}} over matched rows.

    capacity_factor="auto" plans the join exchange (plan_join_capacity);
    the partial-group stage sizes itself from the left capacity."""
    sh = NamedSharding(mesh, P(AXIS))
    ul, ur = U64.from_numpy(lkeys), U64.from_numpy(rkeys)
    lk = U64(jax.device_put(ul.lo, sh), jax.device_put(ul.hi, sh))
    rk = U64(jax.device_put(ur.lo, sh), jax.device_put(ur.hi, sh))
    rv = jax.device_put(jnp.asarray(np.asarray(rvals).astype(np.uint32)),
                        sh)
    kw = _auto_capacity(kw, mesh, plan_join_capacity, (lk, rk),
                        ("capacity_left", "capacity_right"))
    res = distributed_join_aggregate(lk, rk, rv, mesh=mesh,
                                     aggs=tuple(aggs), **kw)
    if int(np.asarray(res[-1]).max()):
        raise RuntimeError("exchange capacity overflow; raise "
                           "capacity_factor")
    n_dev = mesh.shape[AXIS]
    klo = np.asarray(res[0]).reshape(n_dev, -1)
    khi = np.asarray(res[1]).reshape(n_dev, -1)
    inner = tuple(aggs) if "count" in aggs else tuple(aggs) + ("count",)
    cols = []
    res_cols = res[2:-2]
    j = 0
    for a in inner:
        if a == "sum":
            lo_c = np.asarray(res_cols[j]).reshape(n_dev, -1)
            hi_c = np.asarray(res_cols[j + 1]).reshape(n_dev, -1)
            j += 2
            cols.append(lo_c.astype(np.uint64)
                        | (hi_c.astype(np.uint64) << np.uint64(32)))
            continue
        cols.append(np.asarray(res_cols[j]).reshape(n_dev, -1))
        j += 1
    ng = np.asarray(res[-2]).reshape(n_dev, -1)[:, 0]
    out = {}
    for d in range(n_dev):
        for i in range(int(ng[d])):
            k = int(klo[d, i]) | (int(khi[d, i]) << 32)
            row = {a: int(c[d, i]) for a, c in zip(inner, cols)}
            if row["count"] == 0:
                continue
            out[k] = {a: row[a] for a in aggs}
    return out


# --------------------------------------------------------------------------
# distributed set operations (UNION / INTERSECT / EXCEPT, distinct)
# --------------------------------------------------------------------------

def _dset_dedup_route(alo, ahi, blo, bhi, *, n_dev, samples_per_dev):
    """Shared first phase of the distributed set op: local (key, side)
    dedup with exact multiplicities (the exchange-volume reducer) +
    key-splitter routing. Returns (klo, khi, side, occ, is_real, dest,
    my) with padded entries routed to their own device (zero demand)."""
    from tpu_qe.ops.aggregate import _shift_right_one

    n_a, n_b = alo.shape[0], blo.shape[0]
    n = n_a + n_b
    lo = jnp.concatenate([alo, blo])
    hi = jnp.concatenate([ahi, bhi])
    side = jnp.concatenate([jnp.zeros(n_a, jnp.uint32),
                            jnp.ones(n_b, jnp.uint32)])
    shi, slo, ss = jax.lax.sort([hi, lo, side], num_keys=3,
                                is_stable=False)
    pos = jnp.arange(n, dtype=jnp.uint32)
    new = ((pos == 0) | (slo != _shift_right_one(slo, 0))
           | (shi != _shift_right_one(shi, 0))
           | (ss != _shift_right_one(ss, 0)))
    m = jnp.sum(new.astype(jnp.uint32), dtype=jnp.uint32)
    # occurrences per (key, side) tuple: position diffs at tuple ends
    tend = jnp.concatenate([new[1:], jnp.ones((1,), bool)])
    pos1 = pos + 1
    packed = jnp.where(tend, pos1, pos1 | jnp.uint32(1 << 31))
    res = jax.lax.sort([packed, slo, shi, ss], num_keys=1,
                       is_stable=False)
    pe = res[0] & jnp.uint32(0x7FFFFFFF)
    occ = pe - _shift_right_one(pe, 0)
    is_real = pos < m
    klo = jnp.where(is_real, res[1], _ONES)
    khi = jnp.where(is_real, res[2], _ONES)
    sp_lo, sp_hi = sample_splitters(klo, khi, n_dev, samples_per_dev,
                                    n_valid=m)
    my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
    dest = route_by_splitters(klo, khi, sp_lo, sp_hi)
    dest = jnp.where(is_real, dest, my)
    return klo, khi, res[3], occ, is_real, dest, my


def _dset_plan_shard(alo, ahi, blo, bhi, *, n_dev, samples_per_dev):
    """Planning pass: route distinct (key, side) tuples exactly like
    _dset_shard and return the max off-diagonal bucket demand."""
    from tpu_qe.exchange.shuffle import offdiag_demand

    _, _, _, _, _, dest, _ = _dset_dedup_route(
        alo, ahi, blo, bhi, n_dev=n_dev, samples_per_dev=samples_per_dev)
    return offdiag_demand(dest, n_dev).reshape(1)


@functools.partial(jax.jit, static_argnames=("mesh", "samples_per_dev"))
def plan_set_op_capacity(akey: U64, bkey: U64, mesh: Mesh,
                         samples_per_dev: int = 128):
    """Measured off-diagonal exchange demand for the set-op exchange
    (distinct (key, side) tuples after local dedup)."""
    n_dev = mesh.shape[AXIS]
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_dset_plan_shard, n_dev=n_dev,
                          samples_per_dev=samples_per_dev),
        mesh=mesh, in_specs=(spec,) * 4, out_specs=spec, check_vma=False)
    return fn(akey.lo, akey.hi, bkey.lo, bkey.hi)


def _dset_shard(alo, ahi, blo, bhi, *, op, n_dev, samples_per_dev,
                capacity):
    """Local (key, side) dedup with exact multiplicities (compression),
    key-splitter routing, then the local set op on received tuples."""
    from tpu_qe.ops.aggregate import _shift_right_one
    from tpu_qe.ops.segscan import cumsum_u32
    from tpu_qe.ops.setops import _qualifies

    klo, khi, sside, occ, is_real, dest, my = _dset_dedup_route(
        alo, ahi, blo, bhi, n_dev=n_dev, samples_per_dev=samples_per_dev)
    recv, _, _, _, overflow = exchange(
        dest,
        [klo, khi, jnp.where(is_real, sside, 0),
         jnp.where(is_real, occ, 0)],
        [_ONES, _ONES, jnp.uint32(0), jnp.uint32(0)], n_dev, capacity)
    rlo, rhi, rs, ro = recv
    g2hi, g2lo, g2s, g2o = jax.lax.sort([rhi, rlo, rs, ro], num_keys=3,
                                        is_stable=False)
    mm = g2lo.shape[0]
    p2 = jnp.arange(mm, dtype=jnp.uint32)
    sent = (g2lo == _ONES) & (g2hi == _ONES)
    key_new = ((p2 == 0) | (g2lo != _shift_right_one(g2lo, 0))
               | (g2hi != _shift_right_one(g2hi, 0))) & ~sent
    key_end = ~sent & jnp.concatenate(
        [(key_new | sent)[1:], jnp.ones((1,), bool)])
    cum_t = cumsum_u32(g2o)                           # total occurrences
    cum_b = cumsum_u32(jnp.where(g2s > 0, g2o, 0))    # side-B occurrences
    n_keys = jnp.sum(key_end.astype(jnp.uint32), dtype=jnp.uint32)
    packed2 = jnp.where(key_end, p2 + 1, (p2 + 1) | jnp.uint32(1 << 31))
    res2 = jax.lax.sort([packed2, g2lo, g2hi, cum_t, cum_b], num_keys=1,
                        is_stable=False)
    ct = res2[3] - _shift_right_one(res2[3], 0)
    cb = res2[4] - _shift_right_one(res2[4], 0)
    ca = ct - cb
    kvalid = p2 < n_keys
    keep = kvalid & _qualifies(op, ca > 0, cb > 0)
    num = jnp.sum(keep.astype(jnp.uint32), dtype=jnp.uint32)
    packed3 = jnp.where(keep, p2, p2 | jnp.uint32(1 << 31))
    res3 = jax.lax.sort([packed3, res2[1], res2[2], ca, cb], num_keys=1,
                        is_stable=False)
    valid = p2 < num
    return (jnp.where(valid, res3[1], _ONES),
            jnp.where(valid, res3[2], _ONES),
            jnp.where(valid, res3[3], 0), jnp.where(valid, res3[4], 0),
            num.reshape(1), overflow.reshape(1))


@functools.partial(jax.jit, static_argnames=("mesh", "op",
                                             "samples_per_dev",
                                             "capacity_factor",
                                             "capacity"))
def distributed_set_op(akey: U64, bkey: U64, mesh: Mesh, op: str = "union",
                       samples_per_dev: int = 128,
                       capacity_factor: float = 2.0,
                       capacity: int | None = None):
    """DISTINCT-semantics UNION / INTERSECT / EXCEPT over mesh-sharded
    u64 key columns (ops/setops.py semantics, scaled): local (key, side)
    dedup with exact multiplicities is the exchange-volume reducer;
    tuples route by key splitters so every key's verdict is local and
    exact. Returns (klo, khi, count_a, count_b, num, overflow)
    mesh-sharded (splitter-disjoint key ranges across devices)."""
    from tpu_qe.ops.setops import _OPS
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    n_dev = mesh.shape[AXIS]
    n = akey.lo.shape[0] + bkey.lo.shape[0]
    assert akey.lo.shape[0] % n_dev == 0
    assert bkey.lo.shape[0] % n_dev == 0
    if capacity is None:
        capacity = max(int(np.ceil(capacity_factor * (n // n_dev) / n_dev)),
                       16)
    capacity = max(capacity, 16)
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_dset_shard, op=op, n_dev=n_dev,
                          samples_per_dev=samples_per_dev,
                          capacity=capacity),
        mesh=mesh, in_specs=(spec,) * 4,
        out_specs=tuple([spec] * 6), check_vma=False)
    return fn(akey.lo, akey.hi, bkey.lo, bkey.hi)


def distributed_set_op_numpy(a, b, mesh, op="union", **kw):
    """Host wrapper: result keys (ascending) + per-key (count_a,
    count_b) multiplicities over all shards. capacity_factor="auto"
    plans the distinct-tuple exchange demand (plan_set_op_capacity)."""
    sh = NamedSharding(mesh, P(AXIS))
    ua, ub = U64.from_numpy(a), U64.from_numpy(b)
    ak = U64(jax.device_put(ua.lo, sh), jax.device_put(ua.hi, sh))
    bk = U64(jax.device_put(ub.lo, sh), jax.device_put(ub.hi, sh))
    kw = _auto_capacity(kw, mesh, plan_set_op_capacity, (ak, bk),
                        ("capacity",))
    res = distributed_set_op(ak, bk, mesh=mesh, op=op, **kw)
    if int(np.asarray(res[-1]).max()):
        raise RuntimeError("exchange capacity overflow; raise "
                           "capacity_factor")
    n_dev = mesh.shape[AXIS]
    klo = np.asarray(res[0]).reshape(n_dev, -1)
    khi = np.asarray(res[1]).reshape(n_dev, -1)
    ca = np.asarray(res[2]).reshape(n_dev, -1)
    cb = np.asarray(res[3]).reshape(n_dev, -1)
    num = np.asarray(res[4]).reshape(n_dev)
    ks, cas, cbs = [], [], []
    for d in range(n_dev):
        c = int(num[d])
        ks.append(klo[d, :c].astype(np.uint64)
                  | (khi[d, :c].astype(np.uint64) << np.uint64(32)))
        cas.append(ca[d, :c])
        cbs.append(cb[d, :c])
    return (np.concatenate(ks), np.concatenate(cas),
            np.concatenate(cbs))
