"""Sort-based GROUP BY aggregation (hash-aggregate equivalent).

A hash aggregate scatters into a hash table with atomics; this engine's
operators are built on the sort instead (the design it was written with;
whether a scatter-add GROUP BY is faster on a given device is an open
measurement) — so GROUP BY is sort-based: sort rows by group key, find group boundaries,
and reduce each run. All reductions are formulated scatter-free:

- count: difference of row positions at group-end rows;
- integer sum: EXACT u64 (lo, hi) pair — the wrapping u32 cumsum plus a
  cumsum of wrap flags reconstructs the exact 64-bit prefix sum with two
  u32 sweeps (no silent mod-2^32 truncation; x64 stays off);
- float sum: per-SEGMENT inclusive scan (associative_scan with reset at
  group starts), so rounding stays proportional to each group's own
  values — NOT a global-cumsum difference, whose error scales with the
  global prefix magnitude;
- min / max: first/last row of each run after sorting by (key, value-bits)
  with the standard order-preserving float bit transform;
- count_distinct: rows are (key, value)-sorted already, so distinct values
  are contiguous within a group — a (key OR value)-boundary flag cumsum
  differenced at group ends counts them with one extra u32 sweep (SQL's
  COUNT(DISTINCT value) GROUP BY key, the dedup-then-count formulation).

Group-end rows are compacted with one unstable sort whose key packs the
keep/drop bit into bit 31 of the (unique, increasing) row position — order
among kept rows is position order, so stability comes for free and the
operand count stays minimal.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from tpu_qe.bits import U64
from tpu_qe.ops.segscan import (scan_assoc, cumsum_u32,
                               cumsum_u64_pair, cummax_u32)

_VALID_AGGS = ("count", "sum", "min", "max", "count_distinct")


class GroupResult(NamedTuple):
    """Padded GROUP BY result: first `num_groups` rows are valid."""

    key: U64                 # unique group keys, ascending
    aggs: dict               # agg name -> array (padded like key)
    num_groups: jnp.ndarray  # scalar (exact, even past max_groups)
    overflow: jnp.ndarray | None = None  # u32, only when max_groups set


def _searchsorted_u32(sorted_arr: jnp.ndarray,
                      queries: jnp.ndarray) -> jnp.ndarray:
    """First index where sorted_arr >= query (side='left'), per query."""
    m = sorted_arr.shape[0]
    steps = m.bit_length()
    lo_b = jnp.zeros(queries.shape, dtype=jnp.int32)
    hi_b = jnp.full(queries.shape, m, dtype=jnp.int32)

    def body(_, carry):
        lo_b, hi_b = carry
        done = lo_b >= hi_b
        mid = (lo_b + hi_b) // 2
        probe = jnp.take(sorted_arr, jnp.minimum(mid, m - 1))
        go_right = (probe < queries) & ~done
        return (jnp.where(go_right, mid + 1, lo_b),
                jnp.where(go_right | done, hi_b, mid))

    lo_b, hi_b = jax.lax.fori_loop(0, steps, body, (lo_b, hi_b))
    return lo_b


def _float_sortable_bits(x: jnp.ndarray) -> jnp.ndarray:
    """Map f32 to u32 so unsigned order == numeric order (IEEE trick)."""
    b = x.view(jnp.uint32) if x.dtype == jnp.float32 else x
    if x.dtype != jnp.float32:
        return b
    sign = b >> 31
    return jnp.where(sign == 1, ~b, b | jnp.uint32(0x80000000))


def _shift_right_one(x: jnp.ndarray, fill) -> jnp.ndarray:
    return jnp.concatenate([jnp.full((1,), fill, dtype=x.dtype), x[:-1]])


def _op_identity(kind: str, dtype) -> jnp.ndarray:
    if kind == "sum":
        return jnp.zeros((), dtype)
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(jnp.inf if kind == "min" else -jnp.inf, dtype)
    info = jnp.iinfo(dtype)
    return jnp.array(info.max if kind == "min" else info.min, dtype)


def segmented_reduce(values: jnp.ndarray, is_new: jnp.ndarray,
                     kind: str) -> jnp.ndarray:
    """Inclusive per-segment running reduction (scan with segment reset).

    At each row: the reduction of its segment's values up to and including
    itself — so reading at segment-END rows yields the full per-segment
    reduction. kind in {"min", "max", "sum"}; integer sums use global
    cumsum differences instead (exact mod 2^32, cheaper), but FLOAT sums
    must use this (kind="sum") so rounding error stays proportional to
    each segment's own magnitude rather than the global prefix.

    Implemented as a blocked two-level scan (ops/segscan.py) over the
    (segment-start flag, value) monoid — combine(a, b) with a earlier:
    (fa|fb, fb ? vb : op(va, vb)); it runs ~log2(C)+1 full passes
    instead of the log2(n) of a flat strided scan. Float sums: the blocked association order may round
    differently from a strict left fold, but every order keeps error
    proportional to per-segment magnitude (the property this path
    exists for).
    """
    ops = {"min": jnp.minimum, "max": jnp.maximum,
           "sum": lambda a, b: a + b}
    op = ops[kind]
    ident = _op_identity(kind, values.dtype)

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return (fa | fb, jnp.where(fb, vb, op(va, vb)))

    _, v = scan_assoc(combine, (False, ident), (is_new, values))
    return v


def _diff_u64(end_lo, end_hi):
    """Adjacent u64 differences with borrow: pair[i] - pair[i-1] (pair[-1]
    = 0) over (lo, hi) u32 plane arrays — turns inclusive u64 prefix sums
    at group-end rows into exact per-group u64 sums."""
    prev_lo = _shift_right_one(end_lo, jnp.uint32(0))
    prev_hi = _shift_right_one(end_hi, jnp.uint32(0))
    borrow = (end_lo < prev_lo).astype(jnp.uint32)
    return U64(end_lo - prev_lo, end_hi - prev_hi - borrow)


def segmented_sum_u64(vlo: jnp.ndarray, vhi: jnp.ndarray,
                      is_new: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Inclusive per-segment u64 pair sum (Hillis-Steele strided loop).

    Sums (lo, hi) u32-pair values with carry propagation, resetting at
    segment starts — the distributed aggregate's phase-3 combine for
    exact u64 partial sums. Same blocked-scan formulation as
    segmented_reduce; u64 addition is exactly associative, so the blocked
    association order is bit-identical to the flat loop's."""

    def combine(a, b):
        fa, la, ha = a
        fb, lb, hb = b
        slo = la + lb
        carry = (slo < lb).astype(jnp.uint32)
        return (fa | fb, jnp.where(fb, lb, slo),
                jnp.where(fb, hb, ha + hb + carry))

    _, lo, hi = scan_assoc(
        combine, (False, jnp.uint32(0), jnp.uint32(0)), (is_new, vlo, vhi))
    return lo, hi


def group_aggregate(key: U64, value: jnp.ndarray | None = None,
                    aggs: Sequence[str] = ("count",),
                    valid: jnp.ndarray | None = None,
                    max_groups: int | None = None) -> GroupResult:
    """GROUP BY `key` computing `aggs` over `value`.

    Integer "sum" returns an EXACT u64 result as a U64 (lo, hi) pair —
    sums never silently wrap mod 2^32 (the repo convention: padded/static
    paths detect or avoid overflow, never truncate). Value columns here
    are uint32 or float32 (values double as sort keys in this path;
    int32 columns go through group_aggregate_multi, whose sums
    sign-extend to an exact SIGNED i64-in-U64). Float "sum" stays
    float32 (per-segment scan, see segmented_reduce).

    "mean" is a derived aggregate: float32 sum/count (integer values use
    the exact u64 sum widened to f32; float values the per-segment float
    sum). Other aggs pass straight through.

    "count_distinct" is SQL's COUNT(DISTINCT value): the number of
    distinct values per group (u32). Values compare by their
    order-preserving sort bits, so for float32 columns -0.0 and +0.0
    count as two values and NaNs are distinct by payload — integer
    columns have exact SQL semantics. Rows masked out by `valid` are
    excluded before deduplication.

    max_groups (optional): when the caller can bound the group count,
    outputs are padded to max_groups instead of n and the second
    full-stream compaction sort is replaced by a binary search over the
    boundary cumsum + max_groups-sized gathers: meant for low-cardinality
    GROUP BY (its binary search costs log2(n) rounds over max_groups
    queries; the crossover on a given device is not measured). num_groups
    stays EXACT; if it exceeds max_groups the overflow flag is set
    (outputs truncated, never silently wrong).
    """
    aggs = tuple(aggs)
    if "mean" in aggs:
        inner = tuple(dict.fromkeys(
            [a for a in aggs if a != "mean"] + ["sum", "count"]))
        res = _group_aggregate(key, value, aggs=inner, valid=valid,
                               max_groups=max_groups)
        s = res.aggs["sum"]
        c = res.aggs["count"]
        if isinstance(s, U64):  # exact integer pair sum -> float
            sf = (s.hi.astype(jnp.float32) * jnp.float32(2.0**32)
                  + s.lo.astype(jnp.float32))
        else:
            sf = s.astype(jnp.float32) if s.dtype != jnp.float32 else s
        mean = sf / jnp.maximum(c, jnp.uint32(1)).astype(jnp.float32)
        out = {a: res.aggs[a] for a in aggs if a != "mean"}
        out["mean"] = mean
        return GroupResult(res.key, out, res.num_groups, res.overflow)
    return _group_aggregate(key, value, aggs=aggs, valid=valid,
                            max_groups=max_groups)


@functools.partial(jax.jit, static_argnames=("aggs", "max_groups"))
def _group_aggregate(key: U64, value: jnp.ndarray | None = None,
                     aggs: Sequence[str] = ("count",),
                     valid: jnp.ndarray | None = None,
                     max_groups: int | None = None) -> GroupResult:
    """GROUP BY `key` computing `aggs` over `value`.

    Args:
      key: (n,) u64 group keys (e.g. morton cell ids).
      value: (n,) uint32 or float32 column (required unless aggs==("count",)).
      aggs: subset of {"count", "sum", "min", "max", "count_distinct"}.
      valid: optional bool mask — rows where False are excluded, WITHOUT a
        separate compaction pass (the filter fuses into the aggregation
        sort: invalid rows sort to the end as an extra leading key, and
        num_groups counts only groups among valid rows).
    Returns:
      GroupResult with padded outputs (valid rows: [0, num_groups)).
    """
    aggs = tuple(aggs)
    for a in aggs:
        if a not in _VALID_AGGS:
            raise ValueError(f"unknown agg {a!r}")
    need_value = any(a != "count" for a in aggs)
    if need_value and value is None:
        raise ValueError("value column required for sum/min/max")
    n = key.lo.shape[0]

    # sort rows by ([invalid,] key, value-bits): min = first of run, max =
    # last of run, and sums/counts are order-independent within a run.
    operands = []
    if valid is not None:
        operands.append(jnp.where(valid, jnp.uint32(0), jnp.uint32(1)))
    operands += [key.hi, key.lo]
    if value is not None:
        operands.append(_float_sortable_bits(value))
    res = jax.lax.sort(operands, num_keys=len(operands), is_stable=False)
    if valid is not None:
        sinvalid = res[0] > 0
        res = res[1:]
    else:
        sinvalid = None
    if value is not None:
        shi, slo, sval_bits = res[0], res[1], res[2]
        sval = sval_bits  # preserved below via positions, not bits
    else:
        shi, slo = res[0], res[1]
        sval = None
    # recover actual sorted values (inverse of _float_sortable_bits)
    if value is not None and value.dtype == jnp.float32:
        b = sval
        was_positive = (b >> 31) == 1
        sval = jnp.where(was_positive, b ^ jnp.uint32(0x80000000), ~b).view(
            jnp.float32)

    if n == 0:
        pad_n = max_groups if max_groups is not None else 0
        zeros32 = jnp.zeros(pad_n, jnp.uint32)

        def empty(a):
            if a in ("count", "count_distinct") or value is None:
                return zeros32
            if a == "sum" and value.dtype != jnp.float32:
                return U64(zeros32, zeros32)
            return jnp.zeros(pad_n, value.dtype)

        return GroupResult(
            U64(zeros32, zeros32), {a: empty(a) for a in aggs},
            jnp.uint32(0),
            jnp.uint32(0) if max_groups is not None else None)
    prev_lo = _shift_right_one(slo, 0)
    prev_hi = _shift_right_one(shi, 0)
    idx = jnp.arange(n, dtype=jnp.uint32)
    is_new = (idx == 0) | (slo != prev_lo) | (shi != prev_hi)
    if sinvalid is not None:
        # invalid rows sorted to the tail start no group; a valid row ends
        # its group iff the next row starts one, is invalid, or is the end
        is_new = is_new & ~sinvalid
        boundary = is_new | sinvalid
        is_end = ~sinvalid & jnp.concatenate(
            [boundary[1:], jnp.ones((1,), dtype=bool)])
    else:
        is_end = jnp.concatenate([is_new[1:], jnp.ones((1,), dtype=bool)])

    if "count_distinct" in aggs:
        # rows are (key, value-bits)-sorted: a distinct value starts where
        # the group starts or the sorted bit plane changes (bit equality is
        # value equality — _float_sortable_bits is a bijection). Invalid
        # rows sit at the tail and are masked out like is_new.
        pair_new = is_new | (sval_bits != _shift_right_one(sval_bits, 0))
        if sinvalid is not None:
            pair_new = pair_new & ~sinvalid
        cum_nd = cumsum_u32(pair_new.astype(jnp.uint32))  # inclusive

    if max_groups is not None:
        # Gather-based extraction: group-end positions come from a binary
        # search over the (sorted) inclusive cumsum of is_end — log2(n)
        # rounds of max_groups-sized gathers replace the second
        # full-stream sort entirely.
        assert max_groups >= 1
        cum_end = cumsum_u32(is_end.astype(jnp.uint32))
        num_groups = cum_end[-1]
        overflow = (num_groups > jnp.uint32(max_groups)).astype(jnp.uint32)
        j1 = jnp.arange(1, max_groups + 1, dtype=jnp.uint32)
        posi = _searchsorted_u32(cum_end, j1)          # group j ends here
        posc = jnp.minimum(posi, n - 1).astype(jnp.uint32)
        valid_g = jnp.arange(max_groups, dtype=jnp.uint32) < num_groups
        klo = jnp.where(valid_g, jnp.take(slo, posc), jnp.uint32(0xFFFFFFFF))
        khi = jnp.where(valid_g, jnp.take(shi, posc), jnp.uint32(0xFFFFFFFF))
        pos_end = jnp.where(valid_g, posc + 1, jnp.uint32(0))
        prev_pos = _shift_right_one(pos_end, 0)
        out: dict[str, jnp.ndarray] = {}
        if "count" in aggs:
            out["count"] = jnp.where(valid_g, pos_end - prev_pos, 0)
        if "sum" in aggs:
            if sval.dtype == jnp.float32:
                seg_start = (is_new if sinvalid is None
                             else (is_new | sinvalid))
                csum_f = segmented_reduce(sval, seg_start, "sum")
                ce = jnp.take(csum_f, posc)
                out["sum"] = jnp.where(valid_g, ce, jnp.float32(0))
            else:
                clo, chi = cumsum_u64_pair(sval)
                ce_lo = jnp.where(valid_g, jnp.take(clo, posc), 0)
                ce_hi = jnp.where(valid_g, jnp.take(chi, posc), 0)
                s = _diff_u64(ce_lo, ce_hi)
                out["sum"] = U64(jnp.where(valid_g, s.lo, 0),
                                 jnp.where(valid_g, s.hi, 0))
        if "max" in aggs:
            # rows are value-sorted within a group: the end row IS the max
            mx = jnp.take(sval, posc)
            out["max"] = jnp.where(
                valid_g, mx,
                jnp.float32(0) if sval.dtype == jnp.float32 else 0)
        if "min" in aggs:
            mn = jnp.take(sval, jnp.minimum(prev_pos, n - 1))
            out["min"] = jnp.where(
                valid_g, mn,
                jnp.float32(0) if sval.dtype == jnp.float32 else 0)
        if "count_distinct" in aggs:
            # distinct-pair cumsum at the group's end row minus at the
            # previous group's end row — same gather positions as count
            cd = jnp.where(valid_g, jnp.take(cum_nd, posc), jnp.uint32(0))
            out["count_distinct"] = jnp.where(
                valid_g, cd - _shift_right_one(cd, 0), jnp.uint32(0))
        return GroupResult(U64(klo, khi), out, num_groups, overflow)

    # Compact group-END rows to the front with ONE sort whose key packs
    # the keep/drop flag into bit 31 of the (unique, increasing) position:
    # within kept rows the order is position order, i.e. stable for free,
    # so the sort can be unstable and carries the minimum operand count.
    assert n < (1 << 31), n
    pos1 = idx + 1  # inclusive row count (1-based end position)
    packed = jnp.where(is_end, pos1, pos1 | jnp.uint32(1 << 31))
    operands = [packed, slo, shi]
    if "sum" in aggs:
        if sval.dtype == jnp.float32:
            # Per-SEGMENT inclusive float sum (scan with reset at group
            # starts): differencing one GLOBAL running cumsum makes a small
            # group's error scale with the global prefix magnitude — at
            # 256M rows that can wipe out the group's significant digits.
            seg_start = is_new if sinvalid is None else (is_new | sinvalid)
            operands.append(
                segmented_reduce(sval, seg_start, "sum").view(jnp.uint32))
        else:
            # exact u64 (lo, hi) pair prefix sums: one extra sort operand
            # buys sums that never silently wrap mod 2^32
            clo, chi = cumsum_u64_pair(sval)
            operands += [clo, chi]
    if "max" in aggs:
        operands.append(sval.view(jnp.uint32)
                        if sval.dtype == jnp.float32 else sval)
    if "count_distinct" in aggs:
        operands.append(cum_nd)
    res2 = jax.lax.sort(operands, num_keys=1, is_stable=False)
    pos_end = res2[0] & jnp.uint32(0x7FFFFFFF)
    klo, khi = res2[1], res2[2]
    num_groups = jnp.sum(is_end.astype(jnp.uint32))
    i = 3
    prev_pos = _shift_right_one(pos_end, 0)
    out: dict[str, jnp.ndarray] = {}
    if "count" in aggs:
        out["count"] = pos_end - prev_pos
    if "sum" in aggs:
        if sval.dtype == jnp.float32:
            # segmented sum: the value at a group-end row IS the group sum
            out["sum"] = res2[i].view(jnp.float32)
            i += 1
        else:
            out["sum"] = _diff_u64(res2[i], res2[i + 1])
            i += 2
    if "max" in aggs:
        mx = res2[i]
        i += 1
        out["max"] = mx.view(jnp.float32) if sval.dtype == jnp.float32 else mx
    if "count_distinct" in aggs:
        cd_end = res2[i]
        i += 1
        out["count_distinct"] = cd_end - _shift_right_one(cd_end, 0)
    if "min" in aggs:
        # the group's first row (its min, since rows are value-sorted within
        # a group) sits at stream index prev_pos — a num_groups-sized gather
        # replaces the second full compaction this used to cost.
        out["min"] = jnp.take(sval, prev_pos)
    return GroupResult(U64(klo, khi), out, num_groups)


def group_aggregate_sorted(key: U64, value: jnp.ndarray | None = None,
                           aggs: Sequence[str] = ("count",),
                           valid: jnp.ndarray | None = None) -> GroupResult:
    """GROUP BY over an ALREADY key-sorted stream — no input sort.

    The consumer of join_fk_scan(output="stream"): the join's merged
    stream is key-sorted with interspersed non-left/padding rows, so a
    join + GROUP BY pipeline pays ONE compaction sort here instead of
    the restore sort + full aggregation sort of the unfused path (two
    large sorts saved; see ops/join.py StreamJoinResult).

    Requirements: key ascending (rows of equal keys contiguous); `valid`
    marks aggregated rows and may be interspersed freely — key runs with
    zero valid rows produce no group. Same exact-u64 integer sums and
    per-segment float sums as group_aggregate. Unlike group_aggregate,
    min/max use segmented scans (values are not sort keys here).
    """
    aggs = tuple(aggs)
    if "mean" in aggs:
        inner = tuple(dict.fromkeys(
            [a for a in aggs if a != "mean"] + ["sum", "count"]))
        res = _group_aggregate_sorted(key, value, aggs=inner, valid=valid)
        s = res.aggs["sum"]
        c = res.aggs["count"]
        if isinstance(s, U64):
            sf = (s.hi.astype(jnp.float32) * jnp.float32(2.0**32)
                  + s.lo.astype(jnp.float32))
        else:
            sf = s
        mean = sf / jnp.maximum(c, jnp.uint32(1)).astype(jnp.float32)
        out = {a: res.aggs[a] for a in aggs if a != "mean"}
        out["mean"] = mean
        return GroupResult(res.key, out, res.num_groups, res.overflow)
    return _group_aggregate_sorted(key, value, aggs=aggs, valid=valid)


@functools.partial(jax.jit, static_argnames=("aggs",))
def _group_aggregate_sorted(key: U64, value: jnp.ndarray | None = None,
                            aggs: Sequence[str] = ("count",),
                            valid: jnp.ndarray | None = None
                            ) -> GroupResult:
    aggs = tuple(aggs)
    for a in aggs:
        if a not in _VALID_AGGS:
            raise ValueError(f"unknown agg {a!r}")
    if "count_distinct" in aggs:
        # the stream is key-sorted but NOT value-sorted within a group, so
        # distinct values are not contiguous — count_distinct needs the
        # (key, value) aggregation sort: use group_aggregate.
        raise ValueError("count_distinct requires the value-sorted path; "
                         "use group_aggregate")
    need_value = any(a != "count" for a in aggs)
    if need_value and value is None:
        raise ValueError("value column required for sum/min/max")
    n = key.lo.shape[0]
    if n == 0:
        zeros32 = jnp.zeros(0, jnp.uint32)

        def empty(a):
            if a in ("count", "count_distinct") or value is None:
                return zeros32
            if a == "sum" and value.dtype != jnp.float32:
                return U64(zeros32, zeros32)
            return jnp.zeros(0, value.dtype)

        return GroupResult(U64(zeros32, zeros32),
                           {a: empty(a) for a in aggs}, jnp.uint32(0))
    if valid is None:
        valid = jnp.ones(n, dtype=bool)

    slo, shi = key.lo, key.hi
    idx = jnp.arange(n, dtype=jnp.uint32)
    is_new = ((idx == 0) | (slo != _shift_right_one(slo, 0))
              | (shi != _shift_right_one(shi, 0)))
    is_end = jnp.concatenate([is_new[1:], jnp.ones((1,), bool)])

    v32 = valid.astype(jnp.uint32)
    vcnt = cumsum_u32(v32)
    # per-run inclusive valid count WITHOUT a gather: forward-fill the
    # before-run total (vcnt - valid at run starts is non-decreasing
    # across runs, so one cummax fills it to every row of the run)
    base = cummax_u32(jnp.where(is_new, vcnt - v32, jnp.uint32(0)))
    run_count = vcnt - base
    keep = is_end & (run_count > 0)   # zero-valid key runs drop out
    num_groups = jnp.sum(keep.astype(jnp.uint32))

    assert n < (1 << 31), n
    pos1 = idx + 1
    packed = jnp.where(keep, pos1, pos1 | jnp.uint32(1 << 31))
    operands = [packed, slo, shi]
    if "count" in aggs:
        operands.append(run_count)
    mval = None
    if need_value:
        mval = value
    if "sum" in aggs:
        if mval.dtype == jnp.float32:
            operands.append(segmented_reduce(
                jnp.where(valid, mval, jnp.float32(0)), is_new,
                "sum").view(jnp.uint32))
        else:
            # masked exact u64 pair cumsum: dropped runs contribute zero,
            # so differencing consecutive KEPT ends stays exact
            clo, chi = cumsum_u64_pair(jnp.where(valid, mval, 0))
            operands += [clo, chi]
    for a in ("min", "max"):
        if a in aggs:
            mv = jnp.where(valid, mval, _op_identity(a, mval.dtype))
            r = segmented_reduce(mv, is_new, a)
            operands.append(r.view(jnp.uint32)
                            if r.dtype != jnp.uint32 else r)
    res2 = jax.lax.sort(operands, num_keys=1, is_stable=False)
    klo, khi = res2[1], res2[2]
    i = 3
    out: dict = {}
    if "count" in aggs:
        out["count"] = res2[i]
        i += 1
    if "sum" in aggs:
        if mval.dtype == jnp.float32:
            out["sum"] = res2[i].view(jnp.float32)
            i += 1
        else:
            out["sum"] = _diff_u64(res2[i], res2[i + 1])
            i += 2
    for a in ("min", "max"):
        if a in aggs:
            r = res2[i]
            i += 1
            out[a] = (r.view(mval.dtype)
                      if mval.dtype != jnp.uint32 else r)
    return GroupResult(U64(klo, khi), out, num_groups)


class MultiGroupResult(NamedTuple):
    """Padded multi-column GROUP BY result."""

    key: U64                 # unique group keys, ascending
    aggs: dict               # "column_agg" -> array (padded like key)
    num_groups: jnp.ndarray  # scalar (exact, even past max_groups)
    overflow: jnp.ndarray | None = None  # u32, only when max_groups set


@functools.partial(jax.jit, static_argnames=("spec", "max_groups"))
def _group_aggregate_multi(key: U64, cols: tuple, spec: tuple,
                           valid: jnp.ndarray | None,
                           max_groups: int | None = None):
    n = key.lo.shape[0]
    names = [s[0] for s in spec]
    per_col_aggs = {s[0]: s[1] for s in spec}
    dtypes = {nm: c.dtype for nm, c in zip(names, cols)}

    operands = []
    if valid is not None:
        operands.append(jnp.where(valid, jnp.uint32(0), jnp.uint32(1)))
    operands += [key.hi, key.lo]
    num_keys = len(operands)
    operands += [c.view(jnp.uint32) if c.dtype != jnp.uint32 else c
                 for c in cols]
    res = jax.lax.sort(operands, num_keys=num_keys, is_stable=False)
    if valid is not None:
        sinvalid = res[0] > 0
        res = res[1:]
    else:
        sinvalid = None
    shi, slo = res[0], res[1]
    scols = {nm: (c.view(dtypes[nm]) if dtypes[nm] != jnp.uint32 else c)
             for nm, c in zip(names, res[2:])}

    if n == 0:
        pad_n = max_groups if max_groups is not None else 0
        zeros32 = jnp.zeros(pad_n, jnp.uint32)
        out = {}
        for nm in names:
            for a in per_col_aggs[nm]:
                if a == "sum" and dtypes[nm] != jnp.float32:
                    out[f"{nm}_{a}"] = U64(zeros32, zeros32)
                else:
                    dt = jnp.uint32 if a == "count" else dtypes[nm]
                    out[f"{nm}_{a}"] = jnp.zeros(pad_n, dt)
        return MultiGroupResult(
            U64(zeros32, zeros32), out, jnp.uint32(0),
            jnp.uint32(0) if max_groups is not None else None)

    idx = jnp.arange(n, dtype=jnp.uint32)
    is_new = ((idx == 0) | (slo != _shift_right_one(slo, 0))
              | (shi != _shift_right_one(shi, 0)))
    if sinvalid is not None:
        is_new = is_new & ~sinvalid
        boundary = is_new | sinvalid
        is_end = ~sinvalid & jnp.concatenate(
            [boundary[1:], jnp.ones((1,), dtype=bool)])
    else:
        is_end = jnp.concatenate([is_new[1:], jnp.ones((1,), dtype=bool)])

    # inclusive per-segment reductions in stream order (value columns are
    # NOT sort keys here — segmented scans handle min/max directly).
    # Each entry is (out_name, agg, dtype, plane arrays): integer sums
    # carry TWO u32 planes (exact u64 pair, see segscan.cumsum_u64_pair); counts carry
    # none (derived from the packed positions after compaction).
    reduced = []
    pos1 = idx + 1
    for nm in names:
        v = scols[nm]
        for a in per_col_aggs[nm]:
            name = f"{nm}_{a}"
            if a == "count":
                reduced.append((name, a, jnp.uint32, []))
            elif a == "sum":
                if v.dtype == jnp.float32:
                    # per-segment scan: rounding stays proportional to
                    # the group's own values (a global-cumsum difference
                    # loses the group to the global prefix's ulp)
                    reduced.append((name, a, v.dtype,
                                    [segmented_reduce(v, is_new, "sum")]))
                elif v.dtype == jnp.int32:
                    # sign-extend into the hi plane: the pair prefix is
                    # the exact SIGNED sum in two's complement, and the
                    # group difference (_diff_u64, mod 2^64) stays exact
                    # — an i64-in-U64, same convention as ops/window.py
                    reduced.append((name, a, v.dtype, list(
                        cumsum_u64_pair(
                            v.view(jnp.uint32),
                            jnp.where(v < 0, jnp.uint32(0xFFFFFFFF),
                                      jnp.uint32(0))))))
                else:
                    reduced.append((name, a, v.dtype,
                                    list(cumsum_u64_pair(v))))
            else:
                reduced.append((name, a, v.dtype,
                                [segmented_reduce(v, is_new, a)]))

    if max_groups is not None:
        # gather-based extraction (same design as group_aggregate's
        # max_groups path): binary search over the boundary cumsum +
        # max_groups-sized gathers of every reduced plane replace the
        # full-stream compaction sort. Measured crossover ~100K groups.
        assert max_groups >= 1
        cum_end = cumsum_u32(is_end.astype(jnp.uint32))
        num_groups = cum_end[-1]
        overflow = (num_groups > jnp.uint32(max_groups)).astype(jnp.uint32)
        j1 = jnp.arange(1, max_groups + 1, dtype=jnp.uint32)
        posc = jnp.minimum(_searchsorted_u32(cum_end, j1),
                           n - 1).astype(jnp.uint32)
        valid_g = jnp.arange(max_groups, dtype=jnp.uint32) < num_groups
        klo = jnp.where(valid_g, jnp.take(slo, posc), jnp.uint32(0xFFFFFFFF))
        khi = jnp.where(valid_g, jnp.take(shi, posc), jnp.uint32(0xFFFFFFFF))
        pos_end = jnp.where(valid_g, posc + 1, jnp.uint32(0))
        prev_pos = _shift_right_one(pos_end, 0)
        out = {}
        for name, a, dt, ps in reduced:
            if a == "count":
                out[name] = jnp.where(valid_g, pos_end - prev_pos, 0)
            elif a == "sum" and dt != jnp.float32:
                ce_lo = jnp.where(valid_g, jnp.take(ps[0], posc), 0)
                ce_hi = jnp.where(valid_g, jnp.take(ps[1], posc), 0)
                s = _diff_u64(ce_lo, ce_hi)
                out[name] = U64(jnp.where(valid_g, s.lo, 0),
                                jnp.where(valid_g, s.hi, 0))
            else:
                rv = jnp.take(ps[0], posc)
                out[name] = jnp.where(
                    valid_g, rv,
                    jnp.zeros((), dt) if dt == jnp.float32 else 0)
        return MultiGroupResult(U64(klo, khi), out, num_groups, overflow)

    assert n < (1 << 31), n
    packed = jnp.where(is_end, pos1, pos1 | jnp.uint32(1 << 31))
    ops2 = [packed, slo, shi] + [
        (p.view(jnp.uint32) if p.dtype != jnp.uint32 else p)
        for (_, _, _, ps) in reduced for p in ps]
    res2 = jax.lax.sort(ops2, num_keys=1, is_stable=False)
    pos_end = res2[0] & jnp.uint32(0x7FFFFFFF)
    klo, khi = res2[1], res2[2]
    num_groups = jnp.sum(is_end.astype(jnp.uint32))
    prev_pos = _shift_right_one(pos_end, 0)

    out = {}
    j = 3
    for name, a, dt, ps in reduced:
        if a == "count":
            out[name] = pos_end - prev_pos
            continue
        if a == "sum" and dt != jnp.float32:
            out[name] = _diff_u64(res2[j], res2[j + 1])
            j += 2
            continue
        out[name] = res2[j].view(dt) if dt != jnp.uint32 else res2[j]
        j += 1
    return MultiGroupResult(U64(klo, khi), out, num_groups)


def group_aggregate_multi(key: U64, values: dict, aggs: dict,
                          valid: jnp.ndarray | None = None,
                          max_groups: int | None = None
                          ) -> MultiGroupResult:
    """Multi-column GROUP BY: one key sort shared across all aggregations.

    SQL shape: SELECT count(*), sum(a), min(b), max(b) ... GROUP BY key.
    Unlike group_aggregate, value columns are payloads rather than sort
    keys — per-run min/max come from segmented scans (segmented_reduce),
    so any number of (column, agg) pairs share one sort + one compaction.

    Args:
      key: (n,) u64 group keys.
      values: {column_name: (n,) uint32/int32/float32 array}.
      aggs: {column_name: tuple of "count"/"sum"/"min"/"max"}.
      valid: optional bool row mask (fused filter, see group_aggregate).
      max_groups: optional low-cardinality extraction — outputs pad to
        max_groups and the compaction sort is replaced by a binary
        search + tiny gathers over EVERY reduced plane (same measured
        trade-off as group_aggregate: faster up to ~100K groups, exact
        num_groups + overflow flag past the bound).
    Returns:
      MultiGroupResult; aggs dict keyed "column_agg". Integer sums are
      EXACT U64 (lo, hi) pairs: the exact u64 sum for uint32 columns,
      and for int32 columns the exact SIGNED sum as a two's-complement
      i64-in-U64 (sign extension into the hi plane; read with
      .to_numpy().astype(np.int64)). Float sums are per-segment scans,
      so rounding scales with each group's own values.
    """
    names = tuple(sorted(values))
    for nm in names:
        for a in aggs.get(nm, ()):
            if a not in _VALID_AGGS:
                raise ValueError(f"unknown agg {a!r} for column {nm!r}")
            if a == "count_distinct":
                # value columns are not sort keys here (segmented scans);
                # COUNT(DISTINCT col) needs the (key, col) sort — run
                # group_aggregate on that one column.
                raise ValueError(
                    f"count_distinct on {nm!r}: unsupported in the "
                    "multi-column path; use group_aggregate per column")
    spec = tuple((nm, tuple(aggs[nm])) for nm in names if nm in aggs)
    cols = tuple(values[nm] for nm, _ in spec)
    return _group_aggregate_multi(key, cols, spec, valid,
                                  max_groups=max_groups)
