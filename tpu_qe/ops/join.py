"""Joins on u64 keys over columnar tables.

Hash-join engines radix-partition both sides and probe per-partition hash
tables; this engine's formulation is sort + vectorized binary search: the
key sort IS the partitioner, and probing is a data-independent log2(m)
gather loop (no hash tables, no collisions, fully vectorized).

Implemented:
- ``join_fk``: foreign-key (right-unique) equi-join — every left row matches
  at most one right row; static output shapes with a match mask.
- ``join_sorted``: joins two pre-sorted key columns, returning for each left
  row the [start, end) range of matches in the right table (the "join
  index"); materialization of one-to-many results is left to the caller
  (dynamic sizes do not fit jit's static shapes; ranges do).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_qe.bits import U64
from tpu_qe.ops.segscan import scan_assoc, cumsum_u32, cummax_u32
from tpu_qe.table import Table


def searchsorted_u64(sorted_key: U64, query: U64, side: str = "left"):
    """Vectorized binary search over a sorted u64-pair array.

    Returns insertion positions (int32), shape of query.
    """
    s_lo, s_hi = sorted_key
    q_lo, q_hi = query
    m = s_lo.shape[0]
    # m+1 possible answers (0..m): need ceil(log2(m+1)) halvings of the
    # [lo, hi] bracket; max(m-1,1).bit_length() is one short exactly when
    # m is a power of two (the common case here — block sizes are powers
    # of two), which made join_fk miss real matches.
    steps = m.bit_length()
    lo_b = jnp.zeros(q_lo.shape, dtype=jnp.int32)
    hi_b = jnp.full(q_lo.shape, m, dtype=jnp.int32)

    def probe_less(mid):
        p_lo = jnp.take(s_lo, mid)
        p_hi = jnp.take(s_hi, mid)
        if side == "left":
            # advance while s[mid] < q
            return (p_hi < q_hi) | ((p_hi == q_hi) & (p_lo < q_lo))
        # side == "right": advance while s[mid] <= q
        return (p_hi < q_hi) | ((p_hi == q_hi) & (p_lo <= q_lo))

    def body(_, carry):
        lo_b, hi_b = carry
        # once the bracket closes (lo==hi) further iterations must be
        # no-ops: mid would equal hi (possibly m, out of bounds — clamped
        # gathers then read s[m-1] and an all-ones query advances lo past
        # m, returning m+1)
        done = lo_b >= hi_b
        mid = (lo_b + hi_b) // 2
        go_right = probe_less(mid) & ~done
        return (jnp.where(go_right, mid + 1, lo_b),
                jnp.where(go_right | done, hi_b, mid))

    lo_b, hi_b = jax.lax.fori_loop(0, steps, body, (lo_b, hi_b))
    return lo_b


class FkJoinResult(NamedTuple):
    """Foreign-key join output: left rows + gathered right columns."""

    table: Table          # left columns + right columns (right_ prefix-free)
    matched: jnp.ndarray  # bool mask: left row had a right match


@jax.jit
def _join_fk_impl(left: Table, right_sorted: Table, lkey: U64, rkey: U64):
    pos = searchsorted_u64(rkey, lkey)
    m = rkey.lo.shape[0]
    pos_c = jnp.minimum(pos, m - 1)
    hit_lo = jnp.take(rkey.lo, pos_c)
    hit_hi = jnp.take(rkey.hi, pos_c)
    matched = (pos < m) & (hit_lo == lkey.lo) & (hit_hi == lkey.hi)
    gathered = right_sorted.take(pos_c)
    cols = {}
    for name in left:
        cols[name] = left[name]
    for name in gathered:
        out_name = name if name not in cols else f"right_{name}"
        cols[out_name] = gathered[name]
    return Table(cols), matched


def join_fk(left: Table, right: Table, key: str = "key") -> FkJoinResult:
    """Equi-join where right[key] values are unique (foreign-key join).

    Sorts the right table by key (the radix-partition step), then probes
    with a vectorized binary search. Right rows are gathered per left row;
    unmatched left rows get arbitrary gathered values and matched=False.
    """
    rkey = right[key]
    assert isinstance(rkey, U64), "join key must be u64"
    right_sorted = right.sort_by(key)
    skey = right_sorted[key]
    lkey = left[key]
    out, matched = _join_fk_impl(left.drop(key), right_sorted.drop(key),
                                 lkey, skey)
    return FkJoinResult(out.with_column(key, lkey), matched)


class StreamJoinResult(NamedTuple):
    """join_fk_scan's key-ordered STREAM output (output="stream").

    The merged (right + left) stream in global key order, n_l + n_r rows:
      key:      U64 stream keys (sorted ascending)
      lidx:     original left row index (valid only where is_left)
      values:   Table of right value columns, forward-filled (valid only
                where matched; zeroed elsewhere)
      matched:  this row is a VALID left row with a right match
      is_left:  this row is a valid left row (the aggregate-mask to use
                for COUNT over all left rows; matched for joined rows)
    """

    key: U64
    lidx: jnp.ndarray
    values: Table
    matched: jnp.ndarray
    is_left: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("output",))
def join_fk_scan(left: Table, right: Table, lkey: U64, rkey: U64,
                 l_valid: jnp.ndarray | None = None,
                 r_valid: jnp.ndarray | None = None,
                 output: str = "left"):
    """Foreign-key equi-join via one sort + cumulative sweeps.

    At scale the probe loop of ``join_fk`` (log2(m) sequential gather
    rounds at XLA's ~68 M elem/s gather throughput) is the wrong shape for
    100M-row joins. This formulation needs ONE sort, one segmented
    forward-fill scan, and one restore sort — zero full-stream gathers:

      1. concatenate right (side=0) and left (side=1) key rows and
         sort by (key, side, index) — each left row lands after its
         matching right row within its key segment;
      2. a single segmented last-valid associative scan forward-fills,
         within each key segment, both the "a valid right precedes me"
         flag (= matched) and that right row's value columns;
      3. deliver (matched, values) back to original left order with a
         sort on the carried left index.

    Left columns never enter the sorted stream — the output is aligned to
    the original left row order, so left columns pass through untouched.
    Right keys should be unique (FK semantics); with duplicates the LAST
    right row in key order wins.

    Optional validity masks support padded inputs (e.g. the distributed
    exchange's padding slots): invalid right rows never fill; invalid left
    rows report matched=False.

    output="left" (default) returns (Table with left cols + right value
    cols, matched bool mask) aligned to the ORIGINAL left row order —
    step 3's restore sort pays for that alignment.

    output="stream" skips the restore sort entirely and returns the
    key-sorted merged stream (StreamJoinResult) — the join's natural
    output: downstream key-keyed operators (GROUP BY via
    group_aggregate_sorted, merge into a sorted pipeline, top-k by key
    range) consume the stream with its validity masks directly, so a
    join + GROUP BY runs TWO large sorts (this one + the aggregate
    compaction) instead of four (restore + aggregate re-sort both
    vanish). left columns are NOT in the stream (only lidx); gather them
    on demand or keep aggregations to right/key columns. Requires
    output="stream" callers to accept key order.
    """
    assert output in ("left", "stream"), output
    n_l = lkey.lo.shape[0]
    n_r = rkey.lo.shape[0]
    n = n_l + n_r
    assert n < (1 << 30), "join_fk_scan supports up to 2^30 combined rows"

    # Operand packing (each extra 200M-row sort operand costs real time):
    # the third sort key is side<<31 | left-row-index — it orders right
    # rows (side 0) before left rows within a key segment, and left rows
    # by original index (equivalent to stable order among equal keys).
    # The validity bit rides the SAME word's bit 30 as payload-only
    # information? No — bit 30 would alter the ordering of left rows; the
    # valid bit is instead packed into bit 30 of a side-channel-free spot:
    # it must not be a key, so it travels in the rpos word of the second
    # sort and in `sidekey`'s bit 30 only for RIGHT rows (whose relative
    # order among equal keys is FK-irrelevant: last-wins already).
    side = jnp.concatenate([jnp.zeros(n_r, jnp.uint32),
                            jnp.ones(n_l, jnp.uint32)])
    klo = jnp.concatenate([rkey.lo, lkey.lo])
    khi = jnp.concatenate([rkey.hi, lkey.hi])
    # right value columns, split into u32 planes (U64 columns become two)
    pay_names_r = list(right)
    r_planes: list = []      # (name, kind) per plane group
    pads_r = []
    for nm in pay_names_r:
        c = right[nm]
        if isinstance(c, U64):
            pads_r.append(jnp.concatenate([c.lo, jnp.zeros(n_l, jnp.uint32)]))
            pads_r.append(jnp.concatenate([c.hi, jnp.zeros(n_l, jnp.uint32)]))
            r_planes.append((nm, "u64"))
        else:
            v = c.view(jnp.uint32) if c.dtype != jnp.uint32 else c
            pads_r.append(jnp.concatenate([v, jnp.zeros(n_l, jnp.uint32)]))
            r_planes.append((nm, str(c.dtype)))
    # right rows carry their own index too, so sidekeys stay unique and
    # the unstable sort is deterministic (duplicate right keys: highest
    # index wins).
    lidx = jnp.concatenate([jnp.arange(n_r, dtype=jnp.uint32),
                            jnp.arange(n_l, dtype=jnp.uint32)])
    rv = (jnp.ones(n_r, jnp.uint32) if r_valid is None
          else r_valid.astype(jnp.uint32))
    lv = (jnp.ones(n_l, jnp.uint32) if l_valid is None
          else l_valid.astype(jnp.uint32))
    valid = jnp.concatenate([rv, lv])
    # sidekey = side<<31 | valid<<30 | lidx. For LEFT rows valid affects
    # ordering only among equal (key, side) rows of differing validity —
    # harmless: matched is masked by l_valid and left output order is
    # restored by lidx alone. For RIGHT rows it orders invalid before
    # valid, which strengthens last-wins (a valid right row wins over
    # pads). One sort operand replaces three.
    sidekey = (side << jnp.uint32(31)) | (valid << jnp.uint32(30)) | lidx

    ops = [khi, klo, sidekey] + pads_r
    res = jax.lax.sort(ops, num_keys=3, is_stable=False)
    shi, slo, ssidekey = res[0], res[1], res[2]
    srv = list(res[3:3 + len(pads_r)])
    sside = ssidekey >> jnp.uint32(31)
    valid_s = (ssidekey >> jnp.uint32(30)) & jnp.uint32(1) > 0
    slidx = ssidekey & jnp.uint32((1 << 30) - 1)

    prev_lo = jnp.concatenate([jnp.zeros(1, jnp.uint32), slo[:-1]])
    prev_hi = jnp.concatenate([jnp.zeros(1, jnp.uint32), shi[:-1]])
    pos = jnp.arange(n, dtype=jnp.uint32)
    is_new = (pos == 0) | (slo != prev_lo) | (shi != prev_hi)
    side_right = sside == 0
    # Only VALID right rows may fill.
    is_right = side_right & valid_s

    # Segmented LAST-VALID forward fill: a blocked two-level sweep
    # (ops/segscan.py) delivers, at every stream row, (a) whether a valid
    # right row precedes it within its key segment — which IS the match
    # flag — and (b) that right row's value columns, directly. This
    # replaces a gather design (cummax of right positions + one jnp.take
    # per column after the restore sort): the sweep streams at memory
    # speed without a gather. The blocked scan runs log2(C)+1 ≈ 11 full
    # passes instead of a flat loop's 28 at 200M rows.
    # Monoid element (s, f, v*): s = "segment boundary inside this span",
    # f = "valid right after the span's last boundary", v = its values.
    # Associative up to don't-care values (v is only consumed when f=1).
    def _fill_combine(a, b):
        sa, fa = a[0], a[1]
        sb, fb = b[0], b[1]
        return (sa | sb, fb | (fa & ~sb)) + tuple(
            jnp.where(fb, vb, va) for va, vb in zip(a[2:], b[2:]))

    state = scan_assoc(
        _fill_combine, (False, False) + (0,) * len(srv),
        (is_new, is_right) + tuple(srv))
    fill_f = state[1]
    fills = list(state[2:])

    if output == "stream":
        is_left = (~side_right) & valid_s
        matched_s = fill_f & is_left
        cols = {}
        i = 0
        for nm, kind in r_planes:
            def m(c):
                return jnp.where(matched_s, c, jnp.uint32(0))
            if kind == "u64":
                cols[nm] = U64(m(fills[i]), m(fills[i + 1]))
                i += 2
            else:
                v = m(fills[i])
                cols[nm] = v.view(kind) if kind != "uint32" else v
                i += 1
        return StreamJoinResult(U64(slo, shi), slidx, Table(cols),
                                matched_s, is_left)

    # deliver (matched, values) back in original left order: among left
    # rows, slidx is a permutation of [0, n_l), so sorting by it (right
    # rows keyed to the end) puts row i of the result at original left
    # row i. The match flag rides BIT 0 of the restore key (slidx << 1 |
    # matched): index-major order is preserved and one whole sort operand
    # disappears (measured model: ~10% of the join at P=1).
    key_order = jnp.where(side_right, jnp.uint32(0xFFFFFFFF),
                          (slidx << jnp.uint32(1))
                          | fill_f.astype(jnp.uint32))
    res2 = jax.lax.sort([key_order] + fills, num_keys=1, is_stable=False)
    matched = (res2[0][:n_l] & jnp.uint32(1)) > 0
    vals_l = [c[:n_l] for c in res2[1:]]
    if l_valid is not None:
        matched = matched & l_valid

    cols = {nm: left[nm] for nm in left}
    i = 0
    for nm, kind in r_planes:
        out_name = nm if nm not in cols else f"right_{nm}"
        def fetch(c):
            return jnp.where(matched, c, jnp.uint32(0))
        if kind == "u64":
            cols[out_name] = U64(fetch(vals_l[i]), fetch(vals_l[i + 1]))
            i += 2
        else:
            v = fetch(vals_l[i])
            cols[out_name] = v.view(kind) if kind != "uint32" else v
            i += 1
    return Table(cols), matched


class SortedJoinIndex(NamedTuple):
    """Join index for one-to-many joins of sorted tables."""

    start: jnp.ndarray  # (n_left,) first matching right row
    end: jnp.ndarray    # (n_left,) one past last matching right row


@jax.jit
def join_sorted(left_key: U64, right_key_sorted: U64) -> SortedJoinIndex:
    """Match ranges of each left key within a sorted right key column."""
    start = searchsorted_u64(right_key_sorted, left_key, side="left")
    end = searchsorted_u64(right_key_sorted, left_key, side="right")
    return SortedJoinIndex(start, end)


class InnerJoinResult(NamedTuple):
    """Materialized one-to-many inner join, padded to a static budget.

    Slots [0, num_out) are real output rows; num_out is EXACT even when it
    exceeds the budget (overflow != 0 — the padded columns are then
    truncated, never silently wrong).
    """

    table: Table              # left cols + right cols per output row
    left_index: jnp.ndarray   # (out_budget,) source left row per slot
    right_index: jnp.ndarray  # (out_budget,) source right row (sorted order)
    num_out: jnp.ndarray      # exact total number of matches (u32)
    overflow: jnp.ndarray     # u32: num_out > out_budget


@functools.partial(jax.jit, static_argnames=("out_budget",))
def expand_ranges(ranges: SortedJoinIndex, out_budget: int):
    """Cumsum-based segment replication of [start, end) match ranges.

    The jit-friendly expansion of a join index into output slots — no
    scatter, no dynamic shapes. For output slot j we need its source left
    row i (the row with offsets[i] <= j < offsets[i+1]) and the within-
    range position t = j - offsets[i]:

      1. counts c_i = end_i - start_i; offsets = exclusive cumsum.
      2. merge two sorted streams by ONE unstable sort: segment MARKERS at
         stream key (offsets[i]<<1 | 0) carrying i, and SLOTS at
         (j<<1 | 1). A marker sorts immediately before the first slot of
         its segment.
      3. both i and offsets[i] are non-decreasing along the merged stream,
         so two cummax forward-fills recover (i, offsets[i]) at every
         slot — the trick that makes replication scatter-free.
      4. compact the slot entries (drop markers) with the packed-position
         sort used everywhere else, then one gather of start[i] yields
         right_index = start[i] + (j - offsets[i]).

    Returns (left_index, right_index, num_out, overflow); slots past
    num_out hold clamped garbage — mask with arange < num_out.
    """
    start, end = ranges.start.astype(jnp.uint32), ranges.end.astype(jnp.uint32)
    n_l = start.shape[0]
    assert out_budget >= 1 and n_l + out_budget < (1 << 30), \
        (n_l, out_budget)
    c = jnp.where(end > start, end - start, jnp.uint32(0))
    total = jnp.sum(c)  # exact while < 2^32
    # u32 cumsum wraps for pathological (near-cross-join) outputs; a
    # float32 shadow sum monotonically detects that regime so overflow is
    # still flagged even when the exact counter has wrapped.
    total_f = jnp.sum(c.astype(jnp.float32))
    offsets = cumsum_u32(c) - c

    # markers for rows with c>0; empty rows key to the sentinel tail
    big = jnp.uint32((1 << 31) - 1)
    mkey = jnp.where(c > 0, (offsets << jnp.uint32(1)), big)
    skey = (jnp.arange(out_budget, dtype=jnp.uint32) << jnp.uint32(1)) \
        | jnp.uint32(1)
    keys = jnp.concatenate([mkey, skey])
    ivals = jnp.concatenate([jnp.arange(n_l, dtype=jnp.uint32) + 1,
                             jnp.zeros(out_budget, jnp.uint32)])
    ovals = jnp.concatenate([offsets + 1,
                             jnp.zeros(out_budget, jnp.uint32)])
    res = jax.lax.sort([keys, ivals, ovals], num_keys=1, is_stable=False)
    skeys, sivals, sovals = res
    fill_i = cummax_u32(sivals)        # i+1, monotone along the stream
    fill_o = cummax_u32(sovals)        # offsets[i]+1, monotone too
    # compact slots (odd stream keys) to the front in j order
    pos = jnp.arange(n_l + out_budget, dtype=jnp.uint32)
    keep = (skeys & jnp.uint32(1)) == 1
    packed = jnp.where(keep, pos, pos | jnp.uint32(1 << 31))
    res2 = jax.lax.sort([packed, fill_i, fill_o], num_keys=1,
                        is_stable=False)
    li = jnp.maximum(res2[1][:out_budget], jnp.uint32(1)) - 1
    off = jnp.maximum(res2[2][:out_budget], jnp.uint32(1)) - 1
    j = jnp.arange(out_budget, dtype=jnp.uint32)
    t = j - jnp.minimum(off, j)
    ri = jnp.take(start, li) + t
    overflow = ((total > jnp.uint32(out_budget))
                | (total_f > jnp.float32(2**31))).astype(jnp.uint32)
    return li, ri, total, overflow


@functools.partial(jax.jit, static_argnames=("out_budget",))
def _join_inner_impl(left: Table, right_sorted: Table, lkey: U64,
                     rkey_sorted: U64, out_budget: int):
    ranges = join_sorted(lkey, rkey_sorted)
    li, ri, num_out, overflow = expand_ranges(ranges, out_budget)
    valid_out = jnp.arange(out_budget, dtype=jnp.uint32) < num_out
    ri = jnp.where(valid_out, ri, jnp.uint32(0))
    li = jnp.where(valid_out, li, jnp.uint32(0))
    cols = {}
    lcols = left.take(li)
    for nm in lcols:
        cols[nm] = lcols[nm]
    rcols = right_sorted.take(ri)
    for nm in rcols:
        out_name = nm if nm not in cols else f"right_{nm}"
        cols[out_name] = rcols[nm]
    return InnerJoinResult(Table(cols), li, ri, num_out, overflow)


@functools.partial(jax.jit, static_argnames=("out_budget",))
def join_inner_padded(left: Table, right: Table, lkey: U64, rkey: U64,
                      l_valid: jnp.ndarray, r_valid: jnp.ndarray,
                      out_budget: int):
    """One-to-many inner join over PADDED inputs (validity-masked rows).

    The distributed shard body: exchanged buffers carry pad rows whose
    keys are all-ones sentinels, and a real all-ones key must not match
    them. The right side is sorted by (key, invalid-flag) so each key
    segment's VALID rows form its prefix; the per-left match count is then
    clipped to the valid prefix via an exclusive prefix-count of validity
    (two tiny gathers), and invalid left rows contribute zero matches.
    Same static-budget + exact-count discipline as join_inner.
    """
    m = rkey.lo.shape[0]
    inval = jnp.where(r_valid, jnp.uint32(0), jnp.uint32(1))
    perm0 = jnp.arange(m, dtype=jnp.uint32)
    res = jax.lax.sort([rkey.hi, rkey.lo, inval, perm0], num_keys=3,
                       is_stable=False)
    rhi_s, rlo_s, inval_s, perm = res
    rkey_s = U64(rlo_s, rhi_s)
    right_s = right.take(perm)
    valid_s = inval_s == 0
    ranges = join_sorted(lkey, rkey_s)
    # P[i] = number of valid right rows in sorted positions [0, i)
    pfx = jnp.concatenate([jnp.zeros(1, jnp.uint32),
                           cumsum_u32(valid_s.astype(jnp.uint32))])
    c = jnp.take(pfx, ranges.end) - jnp.take(pfx, ranges.start)
    c = jnp.where(l_valid, c, jnp.uint32(0))
    li, ri, num_out, overflow = expand_ranges(
        SortedJoinIndex(ranges.start, ranges.start + c.astype(jnp.int32)),
        out_budget)
    valid_out = jnp.arange(out_budget, dtype=jnp.uint32) < num_out
    li = jnp.where(valid_out, li, jnp.uint32(0))
    ri = jnp.where(valid_out, ri, jnp.uint32(0))
    cols = {}
    lcols = left.take(li)
    for nm in lcols:
        cols[nm] = lcols[nm]
    rcols = right_s.take(ri)
    for nm in rcols:
        out_name = nm if nm not in cols else f"right_{nm}"
        cols[out_name] = rcols[nm]
    return InnerJoinResult(Table(cols), li, ri, num_out, overflow)


class OuterJoinResult(NamedTuple):
    """Materialized one-to-many LEFT/FULL OUTER join, padded to static
    budgets (never silent truncation — exact counts always returned).

    The left-expanded section mirrors InnerJoinResult but KEEPS
    unmatched left rows (one output slot each, matched=False, right
    columns zeroed = SQL NULL). FULL OUTER adds the right_only section:
    right rows no left key matches (left columns are absent there — a
    SQL NULL left side; concatenate on the host if a single relation is
    wanted).
    """

    table: Table              # left cols + right cols per output slot
    matched: jnp.ndarray      # (out_budget,) slot's left row had a match
    left_index: jnp.ndarray   # (out_budget,) source left row per slot
    right_index: jnp.ndarray  # (out_budget,) source right row (sorted)
    num_out: jnp.ndarray      # exact rows in the left-expanded section
    overflow: jnp.ndarray     # u32: num_out > out_budget
    right_only: Table | None  # FULL only: padded unmatched right rows
    num_right_only: jnp.ndarray | None  # exact count of those


@functools.partial(jax.jit, static_argnames=("key", "out_budget", "full"))
def _join_outer_impl(left: Table, right_sorted: Table, key: str,
                     out_budget: int, full: bool):
    lkey, rkey_sorted = left[key], right_sorted[key]
    ranges = join_sorted(lkey, rkey_sorted)
    c = (ranges.end - ranges.start).astype(jnp.uint32)
    # LEFT OUTER: unmatched left rows claim ONE slot (right side NULL)
    c_out = jnp.maximum(c, jnp.uint32(1))
    li, ri, num_out, overflow = expand_ranges(
        SortedJoinIndex(ranges.start,
                        ranges.start + c_out.astype(jnp.int32)),
        out_budget)
    valid_out = jnp.arange(out_budget, dtype=jnp.uint32) < num_out
    matched = valid_out & (jnp.take(c, li) > 0)
    li = jnp.where(valid_out, li, jnp.uint32(0))
    ri = jnp.where(matched, ri, jnp.uint32(0))

    def _mask(col, m_):
        if isinstance(col, U64):
            return U64(jnp.where(m_, col.lo, 0), jnp.where(m_, col.hi, 0))
        v = col.view(jnp.uint32) if col.dtype != jnp.uint32 else col
        v = jnp.where(m_, v, jnp.uint32(0))
        return v.view(col.dtype) if col.dtype != jnp.uint32 else v

    # the left key carries through per slot (incl. unmatched slots);
    # right columns are NULL (zero + matched=False) on unmatched slots
    cols = {}
    lcols = left.take(li)
    for nm in lcols:
        cols[nm] = _mask(lcols[nm], valid_out)
    rcols = right_sorted.drop(key).take(ri)
    for nm in rcols:
        out_name = nm if nm not in cols else f"right_{nm}"
        cols[out_name] = _mask(rcols[nm], matched)
    if not full:
        return OuterJoinResult(Table(cols), matched, li, ri, num_out,
                               overflow, None, None)
    # FULL OUTER: right rows covered by NO [start, end) range. Range
    # membership is one searchsorted back the other way: sorted right
    # row j is matched iff some left key equals its key.
    m = rkey_sorted.lo.shape[0]
    shi, slo = jax.lax.sort([lkey.hi, lkey.lo], num_keys=2,
                            is_stable=False)
    r_rng = join_sorted(rkey_sorted, U64(slo, shi))
    r_matched = r_rng.end > r_rng.start
    n_ro = jnp.sum((~r_matched).astype(jnp.uint32), dtype=jnp.uint32)
    pos = jnp.arange(m, dtype=jnp.uint32)
    packed = jnp.where(r_matched, pos | jnp.uint32(1 << 31), pos)
    (_, perm) = jax.lax.sort([packed, pos], num_keys=1, is_stable=False)
    ro_valid = pos < n_ro
    perm = jnp.where(ro_valid, perm, jnp.uint32(0))
    ro = right_sorted.take(perm)
    ro_cols = {nm: _mask(ro[nm], ro_valid) for nm in ro}
    return OuterJoinResult(Table(cols), matched, li, ri, num_out,
                           overflow, Table(ro_cols), n_ro)


def join_outer(left: Table, right: Table, key: str = "key",
               how: str = "left", out_budget: int | None = None
               ) -> OuterJoinResult:
    """One-to-many LEFT or FULL OUTER equi-join.

    how="left": every left row appears — matched rows once per matching
    right row, unmatched rows once with matched=False and right columns
    zeroed (the engine's NULL convention: validity mask + zero).
    how="full": additionally returns right rows with no matching left
    key in `right_only` (sorted-key order incl. the key column, padded,
    exact count — SQL's NULL left side; concatenate on the host if a
    single relation is wanted). A RIGHT OUTER join is how="left" with
    the tables swapped.

    Same static-budget + exact-count discipline as join_inner. The
    reference has no query operators; completes SURVEY §7's join family
    for the outer variants.
    """
    assert how in ("left", "full"), how
    rkey = right[key]
    assert isinstance(rkey, U64), "join key must be u64"
    if out_budget is None:
        out_budget = max(2 * left.num_rows, 16)
    right_sorted = right.sort_by(key)
    return _join_outer_impl(left, right_sorted, key, out_budget,
                            how == "full")


@functools.partial(jax.jit, static_argnames=("out_budget", "full"))
def join_outer_padded(left: Table, right: Table, lkey: U64, rkey: U64,
                      l_valid: jnp.ndarray, r_valid: jnp.ndarray,
                      out_budget: int, full: bool = False):
    """LEFT/FULL OUTER join over PADDED inputs (the distributed shard
    body — join_inner_padded's validity discipline applied to
    join_outer): invalid left rows contribute ZERO slots; valid
    unmatched left rows one NULL-right slot; FULL adds valid right rows
    matched by no VALID left key (real all-ones keys are reserved as
    pad sentinels here, the house exchange convention)."""
    m = rkey.lo.shape[0]
    inval = jnp.where(r_valid, jnp.uint32(0), jnp.uint32(1))
    perm0 = jnp.arange(m, dtype=jnp.uint32)
    res = jax.lax.sort([rkey.hi, rkey.lo, inval, perm0], num_keys=3,
                       is_stable=False)
    rhi_s, rlo_s, inval_s, perm = res
    rkey_s = U64(rlo_s, rhi_s)
    right_s = right.take(perm)
    valid_s = inval_s == 0
    ranges = join_sorted(lkey, rkey_s)
    pfx = jnp.concatenate([jnp.zeros(1, jnp.uint32),
                           cumsum_u32(valid_s.astype(jnp.uint32))])
    c = jnp.take(pfx, ranges.end) - jnp.take(pfx, ranges.start)
    c_out = jnp.where(l_valid, jnp.maximum(c, jnp.uint32(1)),
                      jnp.uint32(0))
    li, ri, num_out, overflow = expand_ranges(
        SortedJoinIndex(ranges.start,
                        ranges.start + c_out.astype(jnp.int32)),
        out_budget)
    valid_out = jnp.arange(out_budget, dtype=jnp.uint32) < num_out
    matched = valid_out & (jnp.take(c, li) > 0)
    li = jnp.where(valid_out, li, jnp.uint32(0))
    ri = jnp.where(matched, ri, jnp.uint32(0))

    def _mask(col, m_):
        if isinstance(col, U64):
            return U64(jnp.where(m_, col.lo, 0), jnp.where(m_, col.hi, 0))
        v = col.view(jnp.uint32) if col.dtype != jnp.uint32 else col
        v = jnp.where(m_, v, jnp.uint32(0))
        return v.view(col.dtype) if col.dtype != jnp.uint32 else v

    cols = {}
    lcols = left.take(li)
    for nm in lcols:
        cols[nm] = _mask(lcols[nm], valid_out)
    rcols = right_s.take(ri)
    for nm in rcols:
        out_name = nm if nm not in cols else f"right_{nm}"
        cols[out_name] = _mask(rcols[nm], matched)
    if not full:
        return OuterJoinResult(Table(cols), matched, li, ri, num_out,
                               overflow, None, None)
    # FULL: valid right rows matched by no valid left key (invalid left
    # keys probe as all-ones sentinels, which no valid right key equals
    # by the convention above)
    ones = jnp.uint32(0xFFFFFFFF)
    plo = jnp.where(l_valid, lkey.lo, ones)
    phi = jnp.where(l_valid, lkey.hi, ones)
    shi2, slo2 = jax.lax.sort([phi, plo], num_keys=2, is_stable=False)
    r_rng = join_sorted(rkey_s, U64(slo2, shi2))
    r_matched = (r_rng.end > r_rng.start) | ~valid_s
    n_ro = jnp.sum((~r_matched).astype(jnp.uint32), dtype=jnp.uint32)
    pos = jnp.arange(m, dtype=jnp.uint32)
    packed = jnp.where(r_matched, pos | jnp.uint32(1 << 31), pos)
    (_, perm2) = jax.lax.sort([packed, pos], num_keys=1, is_stable=False)
    ro_valid = pos < n_ro
    perm2 = jnp.where(ro_valid, perm2, jnp.uint32(0))
    ro_tbl = right_s.with_column("_key", rkey_s).take(perm2)
    ro_cols = {nm: _mask(ro_tbl[nm], ro_valid) for nm in ro_tbl}
    return OuterJoinResult(Table(cols), matched, li, ri, num_out,
                           overflow, Table(ro_cols), n_ro)


def join_inner(left: Table, right: Table, key: str = "key",
               out_budget: int | None = None) -> InnerJoinResult:
    """One-to-many inner equi-join with duplicate right keys.

    Materializes every (left row, matching right row) pair into a padded
    output of static size ``out_budget`` (default 2 * n_left). The exact
    match count is always returned; if it exceeds the budget the result
    sets overflow and the caller re-runs with a bigger budget — the same
    static-shape + exact-count discipline as the distributed exchange
    (never silent truncation).

    Generalizes join_fk (right-unique) to arbitrary key multiplicity;
    completes SURVEY §7's query-operator mandate for the non-FK case.
    """
    rkey = right[key]
    assert isinstance(rkey, U64), "join key must be u64"
    if out_budget is None:
        out_budget = max(2 * left.num_rows, 16)
    right_sorted = right.sort_by(key)
    return _join_inner_impl(left.drop(key), right_sorted.drop(key),
                            left[key], right_sorted[key], out_budget)
