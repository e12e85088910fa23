"""SQL window functions: OVER (PARTITION BY key ORDER BY order).

row_number / rank / dense_rank / running sum-min-max / lag / lead over
partitioned, ordered rows — the scan-shaped half of SQL analytics that
GROUP BY (ops/aggregate.py) does not cover because its output is one row
PER INPUT ROW, not one per group.

Formulation: ONE sort by (partition key, order, position) puts every
partition contiguous and internally ordered (position as the final sort
key buys SQL's stable tie-break while the sort stays unstable/minimal,
the house trick from ops/aggregate.py); after that every window function
is a segmented sweep over the sorted stream, all through the blocked
two-level scan machinery (ops/segscan.py — no gathers, no scatters, no
tuple-carrier associative_scan):

- row_number: idx - (partition-start idx forward-filled by cummax) + 1;
- rank:       same, with the (key, order)-RUN start index instead;
- dense_rank: cumsum of order-change flags, rebased per partition;
- running_sum: per-segment inclusive scan — EXACT u64 (lo, hi) pair for
  integer columns (never silently wraps mod 2^32, the repo convention;
  int32 sign-extends into the hi plane so the pair is the exact signed
  sum as a two's-complement i64-in-U64), per-segment float scan for
  float columns (rounding proportional to the partition's own
  magnitude, see aggregate.segmented_reduce);
- running_min/max: segmented_reduce;
- lag/lead: one-row shifts masked at partition boundaries;
- first_value / last_value / ntile / percent_rank (whole-partition
  frame): the partition's full extent via one extra FLIPPED sweep
  (partition end index / last value are "first" problems on the
  reversed stream — reversal is a relayout, not a scan); distributed
  they ride exchange/dwindow.py's backward carry chain.

The reference has no analytics operators at all (it is a sort test,
/root/reference/src/main.rs); this family exists because SURVEY.md §7
mandates query operators over columnar tables, and windows are the
canonical consumer of the engine's sorted streams. Crucially the
segmented-scan formulation COMPOSES across shards: a distributed window
is local windows plus an O(D) carry exchange (exchange/dwindow.py), the
same block/carry structure segscan uses within one device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_qe.bits import U64
from tpu_qe.ops.aggregate import (_float_sortable_bits, _shift_right_one,
                                  segmented_reduce, segmented_sum_u64)
from tpu_qe.ops.segscan import cumsum_u32, cummax_u32, scan_assoc

_RUNNING = ("running_sum", "running_min", "running_max")
# whole-partition functions: consume the partition's full extent (size /
# first / last), not just the preceding prefix — in-core they cost one
# extra flipped sweep; distributed they need the backward carry
# (exchange/dwindow.py)
_WHOLE = ("first_value", "last_value", "ntile", "percent_rank")
# moving frames (ROWS BETWEEN k-1 PRECEDING AND CURRENT ROW), static k:
# sums are clamped differences of the per-partition prefix at a STATIC
# shift (no gathers); min/max are the log-doubling two-overlapping-
# windows construction with per-step partition masking — O(log k)
# static shifts, idempotency absorbs the overlap
_MOVING = ("moving_sum", "moving_min", "moving_max", "moving_avg")
# whole-partition AGGREGATE frames (SQL's agg OVER (PARTITION BY k)
# with no ORDER BY): the running form's value at the partition END
# broadcast back over the partition (the last_value trick applied to
# the running output — one extra flipped sweep); partition_count is
# the partition extent itself. running_avg = exact running sum pair /
# row_number as f32 (sign-correct for int32).
_TOTAL = ("total_sum", "total_min", "total_max", "total_avg",
          "partition_count", "running_avg")
_RANGE = ("range_sum", "range_min", "range_max", "range_avg")
# moving_count: SQL's COUNT(*) OVER (... ROWS frame) — the clamped
# frame row count min(rn0+1, k) + min(rn_end, b), pure index
# arithmetic (no value column)
_VALID_FUNCS = (("row_number", "rank", "dense_rank", "lag", "lead",
                 "moving_count")
                + _RUNNING + _WHOLE + _MOVING + _TOTAL + _RANGE)


class WindowResult(NamedTuple):
    """Per-row window outputs.

    cols: out_name -> (n,) array; integer running_sum is a U64 (lo, hi)
    pair. With output="input" rows align with the input; with
    output="sorted" rows are in (partition, order, position) order and
    `pos` gives each row's original input position (None for "input").
    """

    cols: dict
    pos: jnp.ndarray | None = None


def _canon_funcs(funcs: dict) -> tuple:
    """dict -> hashable, validated (name, kind, col, fill) tuple spec."""
    spec = []
    for name in sorted(funcs):
        f = funcs[name]
        if isinstance(f, str):
            f = (f,)
        kind = f[0]
        if kind not in _VALID_FUNCS:
            raise ValueError(f"unknown window function {kind!r}")
        col = f[1] if len(f) > 1 else None
        fill = f[2] if len(f) > 2 else 0
        if kind in _RUNNING + _MOVING + _RANGE + (
                "lag", "lead", "first_value", "last_value", "total_sum",
                "total_min", "total_max", "total_avg", "running_avg") \
                and col is None:
            raise ValueError(f"{kind} needs a value column")
        if kind in _RANGE:
            # spec is (kind, col, bound) — bound is the order-value
            # window ("unbounded" = the tie-aware running frame, SQL's
            # default RANGE UNBOUNDED PRECEDING .. CURRENT ROW)
            if fill != "unbounded" and not (
                    isinstance(fill, (int, float))
                    and not isinstance(fill, bool) and fill >= 0):
                raise ValueError(f"{kind} bound must be a non-negative "
                                 f"number or 'unbounded', got {fill!r}")
        if kind in _MOVING:
            # spec is (kind, col, k[, b]) — the static backward width k
            # (incl. the current row; None = UNBOUNDED PRECEDING) rides
            # the fill slot, an optional b-rows FOLLOWING bound packs
            # it into a (k, b) pair (the lag/lead offset precedent)
            b_f = f[3] if len(f) > 3 else 0
            if not (isinstance(b_f, int) and b_f >= 0):
                raise ValueError(f"{kind} FOLLOWING bound must be an "
                                 f"int >= 0, got {b_f!r}")
            if fill is None:
                if b_f < 1:
                    raise ValueError(
                        f"{kind} with UNBOUNDED PRECEDING needs a "
                        "FOLLOWING bound (use the running frame "
                        "otherwise)")
            elif not (isinstance(fill, int) and fill >= 1):
                raise ValueError(f"{kind} needs a static frame width "
                                 f">= 1, got {fill!r}")
            if b_f:
                fill = (fill, b_f)
        if kind in ("lag", "lead"):
            # spec is (kind, col[, fill[, offset]]) — a static offset
            # k != 1 rides the fill slot as a (fill, k) pair (the same
            # slot-packing precedent as moving's width)
            off = f[3] if len(f) > 3 else 1
            if not (isinstance(off, int) and off >= 1):
                raise ValueError(f"{kind} offset must be an int >= 1, "
                                 f"got {off!r}")
            if off != 1:
                fill = (fill, off)
        if kind == "ntile":
            # spec is ("ntile", k) — k rides the col slot syntactically
            # but is the static bucket count
            if not (isinstance(col, int) and col >= 1):
                raise ValueError(f"ntile needs a bucket count >= 1, "
                                 f"got {col!r}")
            spec.append((name, kind, None, col))
            continue
        if kind == "moving_count":
            # spec is ("moving_count", k[, b]) — k rides the col slot
            # (None = UNBOUNDED PRECEDING), optional b-rows FOLLOWING
            kk, bb = col, fill if fill else 0
            if kk is not None and not (isinstance(kk, int) and kk >= 1):
                raise ValueError(f"moving_count needs a frame width "
                                 f">= 1 or None, got {kk!r}")
            if not (isinstance(bb, int) and bb >= 0):
                raise ValueError(f"moving_count FOLLOWING bound must "
                                 f"be an int >= 0, got {bb!r}")
            spec.append((name, kind, None, (kk, bb)))
            continue
        spec.append((name, kind, col, fill))
    return tuple(spec)


@functools.partial(jax.jit,
                   static_argnames=("colnames", "spec", "has_order",
                                    "output"))
def _window(key: U64, order, cols: tuple, colnames: tuple,
            spec: tuple, has_order: bool, output: str):
    n = key.lo.shape[0]
    idx = jnp.arange(n, dtype=jnp.uint32)
    pos = idx

    # one sort: (key, [order,] position) — position last makes the whole
    # composite key unique, so an unstable sort is deterministic and ties
    # resolve by input position (SQL's stable window semantics).
    operands = [key.hi, key.lo]
    if has_order:
        operands.append(_float_sortable_bits(order))
    operands.append(pos)
    num_keys = len(operands)
    operands += [c.view(jnp.uint32) if c.dtype != jnp.uint32 else c
                 for c in cols]
    res = jax.lax.sort(operands, num_keys=num_keys, is_stable=False)
    shi, slo = res[0], res[1]
    sorder = res[2] if has_order else None
    spos = res[num_keys - 1]
    dtypes = {nm: c.dtype for nm, c in zip(colnames, cols)}
    scols = {nm: (c.view(dtypes[nm]) if dtypes[nm] != jnp.uint32 else c)
             for nm, c in zip(colnames, res[num_keys:])}

    is_new = ((idx == 0) | (slo != _shift_right_one(slo, 0))
              | (shi != _shift_right_one(shi, 0)))
    if has_order:
        order_new = is_new | (sorder != _shift_right_one(sorder, 0))
    else:
        order_new = is_new
    is_last = jnp.concatenate([is_new[1:], jnp.ones((1,), bool)])

    out, _ = _window_sorted_cols(
        spec, scols, idx, is_new, order_new, is_last,
        sorder=sorder, odt=None if order is None else order.dtype)

    if output == "sorted":
        return out, spos

    # restore input order: one unstable sort keyed by the (unique)
    # original position, carrying every output plane as u32 views.
    planes, layout = [], []
    for name in sorted(out):
        v = out[name]
        if isinstance(v, U64):
            planes += [v.lo, v.hi]
            layout.append((name, "u64", None))
        else:
            planes.append(v.view(jnp.uint32) if v.dtype != jnp.uint32 else v)
            layout.append((name, "v", v.dtype))
    res2 = jax.lax.sort([spos] + planes, num_keys=1, is_stable=False)
    restored, j = {}, 1
    for name, tag, dt in layout:
        if tag == "u64":
            restored[name] = U64(res2[j], res2[j + 1])
            j += 2
        else:
            restored[name] = (res2[j].view(dt) if dt != jnp.uint32
                              else res2[j])
            j += 1
    return restored, None


def _window_sorted_cols(spec, scols, idx, is_new, order_new, is_last,
                        need_aux: bool = False, sorder=None, odt=None):
    """All window planes over an already partition-sorted stream.

    Returns (out, aux): aux carries the forward-filled partition/run
    start-index planes when need_aux (the distributed carry patch in
    exchange/dwindow.py masks and rebases with them); within one stream
    they are internal and elided unless a function needs them.
    """
    out: dict = {}
    part_start = run_start = part_end = None
    if need_aux:
        part_start = cummax_u32(jnp.where(is_new, idx, jnp.uint32(0)))
        run_start = cummax_u32(jnp.where(order_new, idx, jnp.uint32(0)))
    for name, kind, col, fill in spec:
        if kind == "row_number":
            if part_start is None:
                part_start = cummax_u32(jnp.where(is_new, idx, jnp.uint32(0)))
            out[name] = idx - part_start + 1
        elif kind == "rank":
            if part_start is None:
                part_start = cummax_u32(jnp.where(is_new, idx, jnp.uint32(0)))
            if run_start is None:
                run_start = cummax_u32(
                    jnp.where(order_new, idx, jnp.uint32(0)))
            out[name] = run_start - part_start + 1
        elif kind == "dense_rank":
            # cumsum of order-run starts, rebased to each partition: the
            # value just before the partition's own first run forward-fills
            # by cummax (non-decreasing), so dense = c - base.
            c = cumsum_u32(order_new.astype(jnp.uint32))
            base = cummax_u32(jnp.where(is_new, c - 1, jnp.uint32(0)))
            out[name] = c - base
        elif kind == "running_sum":
            v = scols[col]
            if v.dtype == jnp.float32:
                out[name] = segmented_reduce(v, is_new, "sum")
            else:
                # int32 sign-extends into the hi plane (_pair_planes):
                # the U64 pair is the exact signed sum in two's
                # complement (i64-in-U64); uint32 stays the exact u64.
                lo, hi = segmented_sum_u64(*_pair_planes(v), is_new)
                out[name] = U64(lo, hi)
        elif kind in ("running_min", "running_max"):
            out[name] = segmented_reduce(scols[col], is_new, kind[-3:])
        elif kind in _TOTAL:
            def bcast(x):
                # partition-END value broadcast back over the partition
                # (first_value of the REVERSED stream — a relayout + one
                # fill sweep, no gathers)
                b = jnp.flip(is_last)
                return jnp.flip(_seg_fill(jnp.flip(x), b, b))
            if kind == "partition_count":
                if part_start is None:
                    part_start = cummax_u32(
                        jnp.where(is_new, idx, jnp.uint32(0)))
                if part_end is None:
                    m1 = jnp.uint32(idx.shape[0] - 1)
                    b = jnp.flip(is_last)
                    rev_start = cummax_u32(
                        jnp.where(b, idx, jnp.uint32(0)))
                    part_end = m1 - jnp.flip(rev_start)
                out[name] = part_end - part_start + 1
            elif kind in ("total_min", "total_max"):
                out[name] = bcast(segmented_reduce(scols[col], is_new,
                                                   kind[-3:]))
            else:            # total_sum / total_avg / running_avg
                v = scols[col]
                if v.dtype == jnp.float32:
                    rs = segmented_reduce(v, is_new, "sum")
                    tot = (rs if kind == "running_avg"
                           else bcast(rs))
                    totf = tot
                    pair = None
                else:
                    lo, hi = segmented_sum_u64(*_pair_planes(v), is_new)
                    if kind != "running_avg":
                        lo, hi = bcast(lo), bcast(hi)
                    pair = U64(lo, hi)
                    totf = None
                if kind == "total_sum":
                    out[name] = pair if pair is not None else totf
                else:
                    if part_start is None:
                        part_start = cummax_u32(
                            jnp.where(is_new, idx, jnp.uint32(0)))
                    if kind == "running_avg":
                        den = (idx - part_start + 1).astype(jnp.float32)
                    else:
                        if part_end is None:
                            m1 = jnp.uint32(idx.shape[0] - 1)
                            b = jnp.flip(is_last)
                            rev_start = cummax_u32(
                                jnp.where(b, idx, jnp.uint32(0)))
                            part_end = m1 - jnp.flip(rev_start)
                        den = (part_end - part_start + 1).astype(
                            jnp.float32)
                    num = (totf if totf is not None
                           else _pair_to_f32_signed(
                               pair.lo, pair.hi, v.dtype == jnp.int32))
                    out[name] = num / den
        elif kind in _MOVING:
            if part_start is None:
                part_start = cummax_u32(jnp.where(is_new, idx, jnp.uint32(0)))
            if isinstance(fill, tuple):     # (k, b) FOLLOWING frame
                kk, bb = fill
                if part_end is None:
                    m1 = jnp.uint32(idx.shape[0] - 1)
                    bnd = jnp.flip(is_last)
                    rev_start = cummax_u32(
                        jnp.where(bnd, idx, jnp.uint32(0)))
                    part_end = m1 - jnp.flip(rev_start)
                out[name] = _moving_follow(
                    kind, scols[col], kk, int(bb), is_new, is_last,
                    idx - part_start, part_end - idx)
            else:
                out[name] = _moving(kind, scols[col], int(fill), is_new,
                                    idx - part_start)
        elif kind == "lag":
            v = scols[col]
            f_, k_ = fill if isinstance(fill, tuple) else (fill, 1)
            f = jnp.asarray(f_, v.dtype)
            if k_ == 1:
                out[name] = jnp.where(is_new, f, _shift_right_one(v, f))
            else:
                # offset-k: static relayout + a rank-within-partition
                # mask (rows with fewer than k predecessors fill)
                if part_start is None:
                    part_start = cummax_u32(
                        jnp.where(is_new, idx, jnp.uint32(0)))
                rn0 = idx - part_start
                out[name] = jnp.where(rn0 >= jnp.uint32(k_),
                                      _shift_k(v, k_, f_), f)
        elif kind == "lead":
            v = scols[col]
            f_, k_ = fill if isinstance(fill, tuple) else (fill, 1)
            f = jnp.asarray(f_, v.dtype)
            if k_ == 1:
                nxt = jnp.concatenate([v[1:],
                                       jnp.full((1,), f, v.dtype)])
                out[name] = jnp.where(is_last, f, nxt)
            else:
                if part_end is None:
                    m1 = jnp.uint32(idx.shape[0] - 1)
                    b = jnp.flip(is_last)
                    rev_start = cummax_u32(
                        jnp.where(b, idx, jnp.uint32(0)))
                    part_end = m1 - jnp.flip(rev_start)
                nxt = jnp.concatenate([v[k_:],
                                       jnp.full((k_,), f, v.dtype)])
                out[name] = jnp.where(idx + jnp.uint32(k_) <= part_end,
                                      nxt, f)
        elif kind in _RANGE:
            agg = kind.rsplit("_", 1)[1]
            v = scols[col]
            if fill == "unbounded":
                # tie-aware running frame (SQL's default RANGE
                # UNBOUNDED PRECEDING .. CURRENT ROW): the running
                # value at the LAST peer of each order run, broadcast
                # back over the run (one flip + segmented fill)
                run_lastb = jnp.concatenate([order_new[1:],
                                             jnp.ones((1,), bool)])
                bnd = jnp.flip(run_lastb)

                def rb(x):
                    return jnp.flip(_seg_fill(jnp.flip(x), bnd, bnd))
                if agg in ("sum", "avg"):
                    if v.dtype == jnp.float32:
                        tot, pair = rb(segmented_reduce(v, is_new,
                                                        "sum")), None
                    else:
                        lo, hi = segmented_sum_u64(*_pair_planes(v),
                                                   is_new)
                        pair, tot = U64(rb(lo), rb(hi)), None
                    if agg == "sum":
                        out[name] = pair if pair is not None else tot
                    else:
                        if part_start is None:
                            part_start = cummax_u32(jnp.where(
                                is_new, idx, jnp.uint32(0)))
                        cnt = rb(idx - part_start + 1)
                        num = (tot if pair is None
                               else _pair_to_f32_signed(
                                   pair.lo, pair.hi,
                                   v.dtype == jnp.int32))
                        out[name] = num / cnt.astype(jnp.float32)
                else:
                    out[name] = rb(segmented_reduce(v, is_new, agg))
            else:
                if sorder is None:
                    raise ValueError("bounded RANGE frames need the "
                                     "order plane (in-core window "
                                     "only)")
                if part_start is None:
                    part_start = cummax_u32(jnp.where(
                        is_new, idx, jnp.uint32(0)))
                if agg in ("min", "max"):
                    out[name] = _range_minmax(agg, v, sorder, odt,
                                              fill, is_new, order_new,
                                              part_start, idx)
                    continue
                fsum, fcnt = _range_x(agg, v, sorder, odt, fill,
                                      is_new, order_new, part_start,
                                      idx)
                if agg == "sum":
                    out[name] = fsum
                else:
                    num = (fsum if not isinstance(fsum, U64)
                           else _pair_to_f32_signed(
                               fsum.lo, fsum.hi, v.dtype == jnp.int32))
                    out[name] = num / jnp.maximum(
                        fcnt, jnp.uint32(1)).astype(jnp.float32)
        elif kind == "first_value":
            # forward last-valid fill with the flag ONLY at partition
            # starts = the partition's first value at every row (the
            # join forward-fill monoid, ops/join.py)
            out[name] = _seg_fill(scols[col], is_new, is_new)
        elif kind == "last_value":
            # first_value of the REVERSED stream (whole-partition frame,
            # the useful SQL variant — the default-frame last_value is
            # just the current row); reversal is a relayout, not a sweep
            v = jnp.flip(scols[col])
            b = jnp.flip(is_last)
            out[name] = jnp.flip(_seg_fill(v, b, b))
        elif kind == "moving_count":
            # frame row count, clamped at both partition edges — pure
            # index arithmetic (COUNT takes no value column)
            kk, bb = fill
            if part_start is None:
                part_start = cummax_u32(jnp.where(is_new, idx,
                                                  jnp.uint32(0)))
            if part_end is None:
                m1 = jnp.uint32(idx.shape[0] - 1)
                b = jnp.flip(is_last)
                rev_start = cummax_u32(jnp.where(b, idx, jnp.uint32(0)))
                part_end = m1 - jnp.flip(rev_start)
            rn0 = idx - part_start
            back = (rn0 + 1 if kk is None
                    else jnp.minimum(rn0 + 1, jnp.uint32(kk)))
            out[name] = back + jnp.minimum(part_end - idx,
                                           jnp.uint32(bb))
        elif kind in ("ntile", "percent_rank"):
            if part_start is None:
                part_start = cummax_u32(jnp.where(is_new, idx, jnp.uint32(0)))
            if part_end is None:
                # partition END index: the partition-start fill of the
                # reversed stream, mapped back
                m1 = jnp.uint32(idx.shape[0] - 1)
                b = jnp.flip(is_last)
                rev_start = cummax_u32(jnp.where(b, idx, jnp.uint32(0)))
                part_end = m1 - jnp.flip(rev_start)
            cnt = part_end - part_start + 1
            if kind == "ntile":
                k = jnp.uint32(fill)
                q, r = cnt // k, cnt % k
                rn0 = idx - part_start
                big = r * (q + 1)
                lo_b = rn0 // (q + 1)
                hi_b = r + (rn0 - big) // jnp.maximum(q, 1)
                out[name] = jnp.where(rn0 < big, lo_b, hi_b) + 1
            else:
                if run_start is None:
                    run_start = cummax_u32(
                        jnp.where(order_new, idx, jnp.uint32(0)))
                rank0 = (run_start - part_start).astype(jnp.float32)
                den = jnp.maximum(cnt - 1, jnp.uint32(1)
                                  ).astype(jnp.float32)
                out[name] = rank0 / den
    return out, {"part_start": part_start, "run_start": run_start,
                 "part_end": part_end}


def _shift_k(v, k: int, fill):
    """Static shift right by k rows (relayout, not a gather)."""
    if k == 0:
        return v
    if k >= v.shape[0]:
        return jnp.full(v.shape, fill, v.dtype)
    return jnp.concatenate([jnp.full((k,), fill, v.dtype), v[:-k]])


def _pair_planes(v):
    """(lo, hi) u32 planes whose u64 pair sum is the EXACT integer sum.

    uint32 columns zero-extend (hi = 0). int32 columns SIGN-extend: the
    hi word is 0xFFFFFFFF on negative rows, so the pair sum equals the
    true signed sum in two's complement mod 2^64 — an i64-in-U64. Pair
    sums/differences downstream are mod-2^64 arithmetic, so prefix
    differences and cross-device/bucket carries stay exact for signed
    values too (without this, each negative row silently added 2^32;
    see ADVICE round 3, ops/window.py moving_sum finding).
    """
    if v.dtype == jnp.int32:
        return v.view(jnp.uint32), jnp.where(
            v < 0, jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
    u = v.view(jnp.uint32) if v.dtype != jnp.uint32 else v
    return u, jnp.zeros_like(u)


def _pair_to_f32_signed(lo, hi, signed: bool):
    """f32 value of a u64 pair; two's-complement i64 when signed."""
    if not signed:
        return (lo.astype(jnp.float32)
                + hi.astype(jnp.float32) * jnp.float32(4294967296.0))
    neg = hi >= jnp.uint32(0x80000000)
    # |x| of a two's-complement negative: ~lo + 1 with carry into hi
    mlo = jnp.where(neg, ~lo + jnp.uint32(1), lo)
    mhi = jnp.where(neg, ~hi + (lo == 0).astype(jnp.uint32), hi)
    mag = (mlo.astype(jnp.float32)
           + mhi.astype(jnp.float32) * jnp.float32(4294967296.0))
    return jnp.where(neg, -mag, mag)


def _moving(kind: str, v, k: int, is_new, rn0):
    """Moving frame ROWS BETWEEN k-1 PRECEDING AND CURRENT ROW, clamped
    to the partition (rn0 = row offset within its partition).

    moving_sum: per-partition prefix minus its own value k rows back —
    the shifted operand is in-partition exactly when rn0 >= k, else the
    frame is the whole partition prefix and the subtrahend is zero.
    EXACT u64 pair for uint32 columns; int32 columns sign-extend into
    the hi plane so the pair is the exact SIGNED sum in two's
    complement (i64-in-U64; prefix differences are mod-2^64 and stay
    exact). f32 per-partition prefix difference for float (error
    proportional to the partition prefix).

    moving_min/max: T = log2(largest power of two P <= k) doubling
    steps build partition-clamped width-2^t window reductions from
    static shifts (a shifted operand is masked to the neutral element
    when it crosses the partition start: rn0 < shift); the final frame
    is the combine of two overlapping width-P windows at distance k-P —
    idempotency absorbs the overlap, 2P >= k makes them contiguous.

    moving_avg: moving_sum / min(rn0+1, k) as f32 (exact integer sums
    feed the ratio; SQL AVG returns a numeric, use moving_sum for the
    exact value).
    """
    if kind in ("moving_sum", "moving_avg"):
        if v.dtype == jnp.float32 and kind == "moving_sum":
            s = segmented_reduce(v, is_new, "sum")
            sub = jnp.where(rn0 >= k, _shift_k(s, k, jnp.float32(0)), 0.0)
            return s - sub
        if v.dtype == jnp.float32:
            s = segmented_reduce(v, is_new, "sum")
            ms = s - jnp.where(rn0 >= k,
                               _shift_k(s, k, jnp.float32(0)), 0.0)
        else:
            lo, hi = segmented_sum_u64(*_pair_planes(v), is_new)
            in_part = rn0 >= k
            blo = jnp.where(in_part, _shift_k(lo, k, jnp.uint32(0)),
                            jnp.uint32(0))
            bhi = jnp.where(in_part, _shift_k(hi, k, jnp.uint32(0)),
                            jnp.uint32(0))
            olo = lo - blo
            ohi = hi - bhi - (lo < blo).astype(jnp.uint32)
            if kind == "moving_sum":
                return U64(olo, ohi)
            ms = _pair_to_f32_signed(olo, ohi, v.dtype == jnp.int32)
        cnt = jnp.minimum(rn0 + 1, jnp.uint32(k)).astype(jnp.float32)
        return ms / cnt
    # moving_min / moving_max
    op = jnp.minimum if kind == "moving_min" else jnp.maximum
    if v.dtype == jnp.float32:
        neutral = jnp.float32(jnp.inf if kind == "moving_min" else -jnp.inf)
    elif v.dtype == jnp.int32:
        neutral = jnp.int32(0x7FFFFFFF if kind == "moving_min"
                            else -0x80000000)
    else:
        neutral = jnp.uint32(0xFFFFFFFF if kind == "moving_min" else 0)
    m = v
    if k > 1:
        p = 1 << (k.bit_length() - 1)  # largest power of two <= k
        s = 1
        while s < p:
            sh = jnp.where(rn0 >= s, _shift_k(m, s, neutral), neutral)
            m = op(m, sh)
            s <<= 1
        if k > p:
            sh = jnp.where(rn0 >= k - p, _shift_k(m, k - p, neutral),
                           neutral)
            m = op(m, sh)
    return m


def _moving_follow(kind: str, v, k, b: int, is_new, is_last, rn0,
                   rn_end):
    """Frame ROWS BETWEEN k-1 PRECEDING AND b FOLLOWING (k None =
    UNBOUNDED PRECEDING), clamped to the partition on both sides.

    Composition: the BACKWARD frame at row i (width k incl. the
    current row — the existing _moving machinery / running reduce)
    combined with the FORWARD frame of width b+1 at i, computed as the
    backward frame of the REVERSED stream (jnp.flip is a relayout, not
    a sweep; the reversed stream's partition starts are is_last and
    its row offsets are rn_end = part_end - idx). Row i is counted by
    both parts exactly once: subtracted for sums (exact mod-2^64 U64
    pair arithmetic, so integer frames stay bit-exact; i32 pairs are
    two's-complement), absorbed by idempotency for min/max.
    moving_avg divides the exact frame sum by the clamped frame count
    min(rn0+1, k) + min(rn_end, b)."""
    rv, rnew, rrn = jnp.flip(v), jnp.flip(is_last), jnp.flip(rn_end)
    if kind in ("moving_sum", "moving_avg"):
        if k is None:
            back = (segmented_reduce(v, is_new, "sum")
                    if v.dtype == jnp.float32
                    else U64(*segmented_sum_u64(*_pair_planes(v),
                                                is_new)))
        else:
            back = _moving("moving_sum", v, int(k), is_new, rn0)
        fwd = _moving("moving_sum", rv, int(b) + 1, rnew, rrn)
        if isinstance(back, U64):
            flo, fhi = jnp.flip(fwd.lo), jnp.flip(fwd.hi)
            vlo, vhi = _pair_planes(v)
            s1 = back.lo + flo
            h1 = back.hi + fhi + (s1 < flo).astype(jnp.uint32)
            lo = s1 - vlo
            hi = h1 - vhi - (s1 < vlo).astype(jnp.uint32)
            if kind == "moving_sum":
                return U64(lo, hi)
            ms = _pair_to_f32_signed(lo, hi, v.dtype == jnp.int32)
        else:
            ms = back + jnp.flip(fwd) - v
            if kind == "moving_sum":
                return ms
        kb = (rn0 + 1 if k is None
              else jnp.minimum(rn0 + 1, jnp.uint32(k)))
        cnt = (kb + jnp.minimum(rn_end, jnp.uint32(b))).astype(
            jnp.float32)
        return ms / cnt
    back = (segmented_reduce(v, is_new, kind[-3:]) if k is None
            else _moving(kind, v, int(k), is_new, rn0))
    fwd = jnp.flip(_moving(kind, rv, int(b) + 1, rnew, rrn))
    op = jnp.minimum if kind == "moving_min" else jnp.maximum
    return op(back, fwd)


def _range_qbits(sorder, odt, x):
    """Sortable u32 bits of each row's RANGE lower bound order_i - x,
    saturating in the order dtype (u32 floors at 0, i32 at INT_MIN,
    f32 is exact float subtraction)."""
    from tpu_qe.bits import sortable_u32, sortable_u32_inverse
    ovals = sortable_u32_inverse(sorder, odt)
    if odt == jnp.uint32:
        xq = jnp.uint32(int(x))
        q = jnp.where(ovals >= xq, ovals - xq, jnp.uint32(0))
    elif odt == jnp.int32:
        xq = jnp.int32(int(x))
        r = ovals - xq
        q = jnp.where(r > ovals, jnp.int32(-(1 << 31)), r)  # saturate
    else:
        q = ovals - jnp.float32(x)
    return sortable_u32(q)


# bounded RANGE MIN/MAX builds a (levels x n) sparse table; the flat
# gather index must fit i32 and the table must fit HBM (26 planes at
# 2^25 rows = 3.4 GB) — larger calls raise with this cap in the message
_RANGE_MM_CAP = 1 << 25


def _range_minmax(agg: str, v, sorder, odt, x, is_new, order_new,
                  part_start, idx):
    """RANGE BETWEEN x PRECEDING AND CURRENT ROW for MIN / MAX: the
    frame of row i is every partition row whose ORDER VALUE lies in
    [order_i - x, order_i] (through the current row's last peer).

    Unlike sums, min/max has no prefix-difference form — the frame is
    an interval-min query [s_i, t_i] over the (partition, order)-sorted
    stream, where s_i (first in-bound row) comes from the same query
    union sort _range_x uses and t_i is the run-end broadcast of the
    row index. Both endpoints are per-row dynamic, so the classic
    sparse table answers it: L = log2(n)+1 doubling planes
    P_j[p] = op over stream rows [p, p+2^j-1] (static shifts, no
    partition masking needed — reads stay inside one partition by
    construction), then frame = op(P_j[s], P_j[t-2^j+1]) at
    j = floor(log2(t-s+1)), read with TWO flat n-element gathers into
    the (L*n,) table — this is the one window verb that pays gathers; a
    sort-based alternative needs the same L planes as sort payload
    operands and far more peak HBM. n is capped at 2^25 per call (3.4 GB
    table)."""
    n = v.shape[0]
    if n > _RANGE_MM_CAP:
        raise ValueError(
            f"bounded RANGE {agg} supports up to {_RANGE_MM_CAP} rows "
            f"per call (got {n}): the interval-min sparse table is "
            "(log2(n)+1) x n values in HBM")
    qbits = _range_qbits(sorder, odt, x)
    # union sort: queries (side 0) land immediately before their
    # frame's first value row (side 1) within the partition
    part_id = cumsum_u32(is_new.astype(jnp.uint32))
    z = jnp.zeros(n, jnp.uint32)
    up = jnp.concatenate([part_id, part_id])
    ub = jnp.concatenate([qbits, sorder])
    uside = jnp.concatenate([z, jnp.ones(n, jnp.uint32)])
    upos = jnp.concatenate([idx, idx])
    srt = jax.lax.sort([up, ub, uside, upos], num_keys=4,
                       is_stable=False)
    spid, sside, spos_ = srt[0], srt[2], srt[3]
    uidx = jnp.arange(2 * n, dtype=jnp.uint32)
    useg_new = (uidx == 0) | (spid != _shift_right_one(spid, 0))
    is_val = sside == 1
    # value rows of the partition strictly below the bound = the
    # query's offset from its partition start
    scount = cumsum_u32(is_val.astype(jnp.uint32))
    base = cummax_u32(jnp.where(
        useg_new, scount - is_val.astype(jnp.uint32), jnp.uint32(0)))
    cnt_lt = scount - base
    qsel = jnp.where(is_val, jnp.uint32(0xFFFFFFFF), spos_)
    back = jax.lax.sort([qsel, cnt_lt], num_keys=1, is_stable=False)
    s_idx = part_start + back[1][:n]
    # frame end: the current row's last order peer (run-end broadcast)
    run_lastb = jnp.concatenate([order_new[1:], jnp.ones((1,), bool)])
    bnd = jnp.flip(run_lastb)
    t_idx = jnp.flip(_seg_fill(jnp.flip(idx), bnd, bnd))
    cnt = t_idx - s_idx + jnp.uint32(1)          # >= 1: row i in frame
    lvl = jnp.uint32(31) - jax.lax.clz(cnt)      # floor(log2(cnt))
    neutral = _mm_neutral(agg, v.dtype)
    op = jnp.minimum if agg == "min" else jnp.maximum
    planes, cur = [v], v
    for j in range(max(0, int(n).bit_length() - 1)):
        sh = 1 << j
        if sh >= n:
            break
        cur = op(cur, jnp.concatenate(
            [cur[sh:], jnp.full((sh,), neutral, v.dtype)]))
        planes.append(cur)
    table = jnp.concatenate(planes)
    nn = jnp.uint32(n)
    g1 = lvl * nn + s_idx
    g2 = lvl * nn + (t_idx - (jnp.uint32(1) << lvl) + jnp.uint32(1))
    r1 = jnp.take(table, g1.astype(jnp.int32))
    r2 = jnp.take(table, g2.astype(jnp.int32))
    return op(r1, r2)


def _mm_neutral(agg: str, dtype):
    """Neutral element for a min/max reduction in `dtype`."""
    if dtype == jnp.float32:
        return jnp.float32(jnp.inf if agg == "min" else -jnp.inf)
    if dtype == jnp.int32:
        return jnp.int32(0x7FFFFFFF if agg == "min" else -0x80000000)
    return jnp.uint32(0xFFFFFFFF if agg == "min" else 0)


def _range_x(agg: str, v, sorder, odt, x, is_new, order_new,
             part_start, idx):
    """RANGE BETWEEN x PRECEDING AND CURRENT ROW for SUM / AVG: the
    frame of row i is every partition row whose ORDER VALUE lies in
    [order_i - x, order_i].

    Gather-free (the sort-instead-of-searchsorted house pattern — XLA
    gathers run at 68 M elem/s, sorts at the VPU envelope): the n
    queries (order_i - x, saturating in the order dtype) merge with
    the n value rows in ONE union sort keyed (partition id, order
    bits, side) with queries sorting BEFORE equal-valued rows; each
    query row then reads the running prefix of the last strictly-
    smaller value row via a segmented forward fill (zero when none),
    and one position sort scatters the query results back. frame =
    running[i] - prefix_below[i] — exact mod-2^64 pair arithmetic for
    integer sums. Returns (frame sum U64|f32, frame count u32)."""
    n = v.shape[0]
    qbits = _range_qbits(sorder, odt, x)
    if v.dtype == jnp.float32:
        planes = [segmented_reduce(v, is_new, "sum")]
    else:
        lo, hi = segmented_sum_u64(*_pair_planes(v), is_new)
        planes = [lo, hi]
    # SQL RANGE frames end at the current row's LAST PEER: the
    # minuend is the run-end-broadcast running value (the subtrahend
    # side is already tie-correct — the last value row strictly below
    # the bound closes its own order run)
    run_lastb = jnp.concatenate([order_new[1:], jnp.ones((1,), bool)])
    bnd_ = jnp.flip(run_lastb)

    def _rb(xp):
        return jnp.flip(_seg_fill(jnp.flip(xp), bnd_, bnd_))
    top = [_rb(p) for p in planes]
    top_cnt = _rb(idx - part_start + 1)
    part_id = cumsum_u32(is_new.astype(jnp.uint32))
    z = jnp.zeros(n, jnp.uint32)
    up = jnp.concatenate([part_id, part_id])
    ub = jnp.concatenate([qbits, sorder])
    uside = jnp.concatenate([z, jnp.ones(n, jnp.uint32)])
    upos = jnp.concatenate([idx, idx])
    upay = [jnp.concatenate([z, p]) for p in planes]
    srt = jax.lax.sort([up, ub, uside, upos] + upay, num_keys=4,
                       is_stable=False)
    spid, sside, spos_ = srt[0], srt[2], srt[3]
    uidx = jnp.arange(2 * n, dtype=jnp.uint32)
    useg_new = (uidx == 0) | (spid != _shift_right_one(spid, 0))
    is_val = sside == 1
    filled = [_seg_fill(p, useg_new, is_val) for p in srt[4:]]
    # value-count strictly below the query within its partition
    scount = cumsum_u32(is_val.astype(jnp.uint32))
    base = cummax_u32(jnp.where(
        useg_new, scount - is_val.astype(jnp.uint32), jnp.uint32(0)))
    cnt_lt = scount - base
    # scatter query rows back to window-stream order (queries carry
    # their stream position; value rows sort to the tail)
    qsel = jnp.where(is_val, jnp.uint32(0xFFFFFFFF), spos_)
    back = jax.lax.sort([qsel] + filled + [cnt_lt], num_keys=1,
                        is_stable=False)
    cnt_lt_q = back[-1][:n]
    # _seg_fill carries the previous segment's value across a boundary
    # until the first flagged row — a query with NO value rows below it
    # in its partition must read 0, not the previous partition's prefix
    low = [jnp.where(cnt_lt_q > 0, b[:n], jnp.zeros((), b.dtype))
           for b in back[1:-1]]
    cnt = top_cnt - cnt_lt_q
    if v.dtype == jnp.float32:
        return top[0] - low[0], cnt
    olo = top[0] - low[0]
    ohi = (top[1] - low[1]
           - (top[0] < low[0]).astype(jnp.uint32))
    return U64(olo, ohi), cnt


def _seg_fill(v, boundary, flag):
    """Segmented last-valid forward fill (the ops/join.py monoid): at
    every row, the value of the last flagged row at or before it within
    its segment (0 before any flag)."""
    def combine(a, b):
        sa, fa, va = a
        sb, fb, vb = b
        return (sa | sb, fb | (fa & ~sb), jnp.where(fb, vb, va))

    zero = jnp.zeros((), v.dtype)
    state = scan_assoc(combine, (False, False, zero), (boundary, flag, v))
    return state[2]


def window(key: U64, funcs: dict, order: jnp.ndarray | None = None,
           values: dict | None = None,
           output: str = "input") -> WindowResult:
    """Window functions over PARTITION BY `key` [ORDER BY `order`].

    Args:
      key: (n,) U64 partition keys (e.g. morton cells, sensor ids).
      funcs: out_name -> spec; spec is "row_number" / ("rank",) /
        ("dense_rank",) / ("percent_rank",) /
        ("running_sum"|"running_min"|"running_max", value_col) /
        ("lag"|"lead", value_col[, fill[, offset]]) /
        ("first_value"|"last_value", value_col) / ("ntile", k) /
        ("moving_sum"|"moving_min"|"moving_max"|"moving_avg",
        value_col, k).
        Value columns are looked up in `values` (uint32 / int32 /
        float32). `fill` is the static scalar emitted at partition
        edges (default 0). first_value/last_value use the whole-
        partition frame (SQL's RANGE BETWEEN UNBOUNDED PRECEDING AND
        UNBOUNDED FOLLOWING — the useful variant); percent_rank is
        (rank-1)/(cnt-1) as f32; ntile(k) buckets 1..k sized within 1.
        moving_* is the SQL frame ROWS BETWEEN k-1 PRECEDING AND
        CURRENT ROW with STATIC width k, clamped at partition starts:
        sums via shifted per-partition prefix differences (integer
        moving_sum is an EXACT U64 pair; int32 sign-extends, so the
        pair reads as a two's-complement i64), min/max via O(log k)
        partition-masked doubling shifts, moving_avg = sum/frame-rows
        as f32 (sign-correct for int32) — all static relayouts, no
        gathers (see _moving).
      order: optional (n,) ORDER BY column (uint32/int32/float32). Ties —
        and the no-order case — resolve by input position, so results are
        deterministic. rank/dense_rank require `order`.
      output: "input" (rows align with the input — the default SQL
        contract) or "sorted" (rows in (key, order, position) order;
        WindowResult.pos maps each row to its input position — the cheap
        form when the caller keeps the sorted stream anyway).

    Integer running_sum/moving_sum return an EXACT U64 pair: the exact
    u64 sum for uint32 columns, the exact SIGNED sum as a
    two's-complement i64-in-U64 for int32 columns (sign extension into
    the hi plane; interpret with U64.to_numpy().astype(np.int64)).
    Float running_sum uses the per-segment scan (error proportional to
    the partition's own prefix). One lax.sort + O(#funcs) segmented
    sweeps; "input" adds one restore sort.
    """
    spec = _canon_funcs(funcs)
    if output not in ("input", "sorted"):
        raise ValueError(f"unknown output mode {output!r}")
    if order is None and any(k in ("rank", "dense_rank", "percent_rank")
                             + _RANGE for _, k, _, _ in spec):
        raise ValueError("rank/dense_rank/percent_rank and RANGE "
                         "frames require an order column")
    values = values or {}
    needed = tuple(sorted({c for _, _, c, _ in spec if c is not None}))
    for c in needed:
        if c not in values:
            raise ValueError(f"window spec references missing column {c!r}")
    n = key.lo.shape[0]
    if n == 0:
        z32 = jnp.zeros(0, jnp.uint32)
        cols = {}
        for name, kind, col, _ in spec:
            if (kind in ("running_sum", "moving_sum", "total_sum",
                         "range_sum")
                    and values[col].dtype != jnp.float32):
                cols[name] = U64(z32, z32)
            elif kind in _RUNNING + ("moving_sum", "moving_min",
                                     "moving_max", "lag", "lead",
                                     "first_value", "last_value",
                                     "total_sum", "total_min",
                                     "total_max", "range_sum",
                                     "range_min", "range_max"):
                cols[name] = jnp.zeros(0, values[col].dtype)
            elif kind in ("percent_rank", "moving_avg", "total_avg",
                          "running_avg", "range_avg"):
                cols[name] = jnp.zeros(0, jnp.float32)
            else:
                cols[name] = z32
        return WindowResult(cols, z32 if output == "sorted" else None)
    cols, pos = _window(key, order, tuple(values[c] for c in needed),
                        needed, spec, order is not None, output)
    return WindowResult(cols, pos)
