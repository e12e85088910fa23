"""Out-of-core SQL: GROUP BY aggregates over VIRTUAL tables.

Completes the SQL front door's composition matrix: the in-core executor
(executor.py) runs HBM-resident Tables, the distributed layer shards
them over a mesh (executor._sql_distributed), and this module runs
tables LARGER than one device's HBM — the same per-run-partials shape
as ops/bigagg.py (aggregation IS the compression: only the G-bounded
partial group table survives each run).

Virtual tables: the out-of-core tier does not stream rows from the host
yet, so big tables are DEVICE-GENERATED: each column is a traceable fn(idx: u32 array) ->
u32/i32/f32 array of the same shape. That is the house data model for
everything out-of-core (hash-of-index = regenerable, verifiable; see
sort/bigsort.py) and matches production fact-table scans where columns
derive from a compact seed (synthetic benchmarks, simulation grids,
regenerated projections).

Execution shape for
    SELECT g, COUNT(*), SUM(v), MIN(v), MAX(v), AVG(v), MEDIAN(v)
    FROM big [WHERE p(row)] GROUP BY g [HAVING ...] [ORDER BY ...]:

  phase A (device, out-of-core): ONE jitted run program evaluated per
    run r — generate columns from idx, evaluate the WHERE mask and the
    aggregate argument expressions through the same expression engine
    the in-core executor uses (executor._eval), and partially aggregate
    via ops/aggregate.group_aggregate_multi(valid=mask,
    max_groups=cap). Only the padded partial table leaves the run
    (g-bounded device head slices — executor._head_np).
  phase A' (device, percentiles): MEDIAN / PERCENTILE_DISC|CONT ride
    bigquantile's machinery shape — per-run (key, value)-sorted planes
    stay RESIDENT and 32 host-driven bisection rounds of per-run
    searchsorted counts answer every (group, q) exactly with no merge
    phase (see ops/bigquantile.py; here vectorized per group over the
    combined group table).
  phase B (host, G-bounded): numpy combine of the R partial tables
    (np.unique + add/minimum/maximum.at). Integer sums stay EXACT: u32
    partials are exact u64 pairs summed into u64 (total < 2^64 because
    n < 2^32 rows of u32 values), int32 partials are two's-complement
    i64 (|total| < 2^63). HAVING / ORDER BY / LIMIT finish on the
    G-bounded host frame — the engine's readback boundary.

Reference contrast: the reference sorts one fixed in-memory buffer
(/root/reference/src/main.rs:376-688); out-of-core declarative
aggregation is SURVEY.md §5's scaled mandate composed with the SQL
surface.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.bits import U64
from tpu_qe.table import Table
from tpu_qe.sql import parser as P
from tpu_qe.sql.executor import (Frame, SqlError, _RowEnv, _calls, _eval,
                                 _frame_order_limit, _head_np, _lift_key,
                                 _materialize, _np_binop, _tag_of,
                                 _unlift_key, _AGG_FUNCS, _PCT_FUNCS)


@dataclasses.dataclass
class VirtualTable:
    """Device-generated table: column = fn(idx u32 array) -> array."""
    n: int
    columns: dict            # name -> fn(idx) -> u32/i32/f32 array
    tags: dict               # name -> "u32"|"i32"|"f32" (probed)


def probe_virtual(n: int, columns: dict) -> VirtualTable:
    """Validate generators on an 8-row probe and record column tags."""
    idx = jnp.arange(8, dtype=jnp.uint32)
    tags = {}
    for nm, fn in columns.items():
        c = fn(idx)
        if isinstance(c, U64):
            raise SqlError(f"virtual column {nm!r}: u64 generators are "
                           "not supported (32-bit columns only)")
        if c.shape != (8,):
            raise SqlError(f"virtual column {nm!r}: generator must "
                           "preserve the index shape")
        tags[nm] = _tag_of(c)
    assert 0 < n < (1 << 32), n
    return VirtualTable(int(n), dict(columns), tags)


# ---------------------------------------------------------------------------
# phase A: the per-run partial-aggregation program
# ---------------------------------------------------------------------------

def _gen_env(vt: VirtualTable, idx) -> _RowEnv:
    cols = {nm: fn(idx) for nm, fn in vt.columns.items()}
    return _RowEnv(Table(cols), {nm: nm for nm in cols}, dict(vt.tags))


# ---------------------------------------------------------------------------
# JOIN prep: virtual fact table x in-core dimension table
# ---------------------------------------------------------------------------

def _walk_cols(e, out: list):
    """Collect every P.Col node of an expression AST."""
    if isinstance(e, P.Col):
        out.append(e)
    elif isinstance(e, P.Unary):
        _walk_cols(e.operand, out)
    elif isinstance(e, P.Binary):
        _walk_cols(e.left, out)
        _walk_cols(e.right, out)
    elif isinstance(e, P.Between):
        _walk_cols(e.operand, out)
        _walk_cols(e.lo, out)
        _walk_cols(e.hi, out)
    elif isinstance(e, P.InList):
        _walk_cols(e.operand, out)
        for it in e.items:
            _walk_cols(it, out)
    elif isinstance(e, P.Case):
        for c, v in e.whens:
            _walk_cols(c, out)
            _walk_cols(v, out)
        if e.default is not None:
            _walk_cols(e.default, out)
    elif isinstance(e, P.Call):
        for a in e.args:
            if a != "*":
                _walk_cols(a, out)
        if e.within_order is not None:
            _walk_cols(e.within_order, out)


@dataclasses.dataclass
class _JoinPrep:
    """Resolved virtual-fact x in-core-dimension FK join.

    The dimension side is device-RESIDENT (its planes ride as arguments
    into every run program — never closed over: CLAUDE.md HTTP-413
    rule) and its keys are checked UNIQUE once at prep time (exact
    check; one-to-many would silently last-win in join_fk_scan's FK
    semantics — 'never silently wrong'). Every run joins its generated
    fact rows against the same resident dimension via ops/join.py
    join_fk_scan (one sort + segmented forward-fill sweeps + restore,
    zero full-stream gathers) — the ops/bigjoin shape specialized to a
    dimension that fits HBM, so no key-space bucketing is needed.
    Unmatched rows follow the engine's NULL-zero convention with the
    in-core executor's `<binding>__matched` mask column."""
    fact_binding: str
    dim_binding: str
    how: str                    # "inner" | "left"
    fact_key: str               # fact column name (in vt.columns)
    fact_key_tag: str
    dim_dev: dict               # arg pytree: __klo/__khi + value planes
    val_phys: list              # dim value plane keys, "<binding>.<col>"
    names: dict                 # joined env: ref -> phys
    tags: dict                  # joined env: phys -> tag
    dim_key_phys: str | None    # synthesized dim key column, if referenced
    dim_key_tag: str | None
    matched_phys: str | None    # "<binding>__matched" (LEFT joins)
    n_dim: int

    def apply(self, env: _RowEnv, valid, dim: dict, n: int):
        """Traced: join one run's fact env against the resident dim."""
        from tpu_qe.ops.join import join_fk_scan
        ktv = env.col(P.Col(self.fact_key))
        lkey = _lift_key(ktv.arr, ktv.tag)
        rkey = U64(dim["__klo"], dim["__khi"])
        right = Table({p: dim[p] for p in self.val_phys})
        out, matched = join_fk_scan(env.table, right, lkey, rkey,
                                    l_valid=valid)
        cols = {nm: out[nm] for nm in out.column_names}
        if self.matched_phys is not None:
            cols[self.matched_phys] = matched.astype(jnp.uint32)
        if self.dim_key_phys is not None:
            # on a match the dim key VALUE equals the fact key (same
            # 32-bit tag — cross-tag lifted keys can never be equal);
            # unmatched rows take the NULL-zero fill
            if self.dim_key_tag == self.fact_key_tag:
                kv = jnp.where(matched, ktv.arr,
                               jnp.zeros((), ktv.arr.dtype))
            else:
                kv = jnp.zeros(n, {"u32": jnp.uint32, "i32": jnp.int32,
                                   "f32": jnp.float32}[self.dim_key_tag])
            cols[self.dim_key_phys] = jnp.broadcast_to(kv, (n,))
        env2 = _RowEnv(Table(cols), self.names, self.tags)
        if self.how == "inner":
            valid = valid & matched
        return env2, valid


def _prep_join(vt: VirtualTable, q: P.Query, db, run_size: int
               ) -> _JoinPrep:
    """Resolve and stage the JOIN clause of a big-table query."""
    sel = q.selects[0]
    if len(sel.joins) != 1:
        raise SqlError("big-table SQL supports one JOIN per query")
    j = sel.joins[0]
    if j.how == "full":
        raise SqlError("FULL OUTER JOIN over a big table is not "
                       "supported (unmatched dimension rows need a "
                       "cross-run reduction; use LEFT with sides "
                       "swapped where possible)")
    if db is None:
        raise SqlError("JOIN over a virtual table needs the Database "
                       "context")
    if j.table.name.lower() in getattr(db, "_virtual", {}):
        # defensive: _join_big_sql dispatches virtual x virtual joins
        # to _prep_vv_join before reaching here
        raise SqlError("virtual x virtual JOIN runs through the "
                       "fused aggregate path only (GROUP BY / "
                       "aggregates)")
    dim = db._tables.get(j.table.name.lower())
    if dim is None:
        raise SqlError(f"unknown table {j.table.name!r}")
    fb, dbind = sel.table.binding, j.table.binding

    def fact_side(c: P.Col) -> bool:
        return c.table in (None, fb) and c.name in vt.columns

    def dim_side(c: P.Col) -> bool:
        return c.table in (None, dbind) and c.name in dim.column_names

    a, b = j.left_col, j.right_col
    if fact_side(a) and dim_side(b):
        fkey, dkey = a.name, b.name
    elif fact_side(b) and dim_side(a):
        fkey, dkey = b.name, a.name
    else:
        raise SqlError(f"cannot resolve ON {a.key} = {b.key} against "
                       "the fact/dimension columns")
    n_dim = dim.num_rows
    if n_dim >= (1 << 30) or n_dim + run_size >= (1 << 30):
        raise SqlError("dimension table too large for the per-run "
                       "join (combined rows must stay below 2^30)")

    dktv_arr = dim[dkey]
    dk_tag = _tag_of(dktv_arr)
    dk = _lift_key(dktv_arr, dk_tag)
    # exact uniqueness check: FK semantics would silently last-win on
    # duplicate dimension keys
    slo, shi = jax.lax.sort([dk.lo, dk.hi], num_keys=2, is_stable=False)
    dup = jnp.any((slo[1:] == slo[:-1]) & (shi[1:] == shi[:-1])) \
        if n_dim > 1 else jnp.bool_(False)
    if bool(np.asarray(dup)):
        raise SqlError("dimension keys are not unique — one-to-many "
                       "JOIN over big tables is not supported (the "
                       "FK join would silently keep one match)")

    # referenced dimension columns (pruned: each extra fill plane is a
    # real sort operand in every run)
    refs: list = []
    for it in sel.items:
        if it.expr == "*":
            refs += [P.Col(c, dbind) for c in dim.column_names]
        else:
            _walk_cols(it.expr, refs)
    for e in (sel.where, sel.having):
        if e is not None:
            _walk_cols(e, refs)
    for c in sel.group_by:
        refs.append(c)
    for oi in q.order_by:
        refs.append(oi.col)
    want_dim = set()
    for c in refs:
        if c.table == dbind and c.name in dim.column_names:
            want_dim.add(c.name)
        elif (c.table is None and c.name in dim.column_names
              and c.name not in vt.columns):
            want_dim.add(c.name)

    fkt = vt.tags[fkey]
    dim_key_phys = dim_key_tag = None
    val_names = sorted(want_dim - {dkey})
    val_phys = [f"{dbind}.{c}" for c in val_names]
    dim_dev = {"__klo": dk.lo, "__khi": dk.hi}
    tags: dict = dict(vt.tags)
    names: dict = {}
    for c in vt.columns:
        names[c] = c
        names[f"{fb}.{c}"] = c
    for c, p in zip(val_names, val_phys):
        t = _tag_of(dim[c])
        if t == "u64":
            raise SqlError(f"dimension column {c!r}: u64 value "
                           "columns are not supported in the big-table "
                           "join (32-bit fills only)")
        arr = dim[c]
        dim_dev[p] = arr
        tags[p] = t
        names[p] = p
        if c in vt.columns:
            names.pop(c, None)      # ambiguous bare name
        else:
            names[c] = p
    if dkey in want_dim:
        dim_key_phys = f"{dbind}.{dkey}"
        dim_key_tag = dk_tag
        tags[dim_key_phys] = dk_tag
        names[dim_key_phys] = dim_key_phys
        if dkey in vt.columns:
            names.pop(dkey, None)
        else:
            names[dkey] = dim_key_phys
    matched_phys = None
    if j.how == "left":
        matched_phys = f"{dbind}__matched"
        tags[matched_phys] = "u32"
        names[matched_phys] = matched_phys
    return _JoinPrep(fb, dbind, j.how, fkey, fkt, dim_dev, val_phys,
                     names, tags, dim_key_phys, dim_key_tag,
                     matched_phys, n_dim)


def _build_env(vt: VirtualTable, prep: _JoinPrep | None, where, idx,
               n: int, dim: dict):
    """Traced: (env, valid) for one run — generate fact columns, apply
    the join (if any), then the WHERE mask (which may reference joined
    columns)."""
    env = _gen_env(vt, idx)
    valid = idx < jnp.uint32(vt.n)      # tail-run mask
    if prep is not None:
        env, valid = prep.apply(env, valid, dim, n)
    if where is not None:
        tv = _eval(where, env, n)
        if tv.tag != "bool":
            raise SqlError("WHERE must be boolean")
        valid = valid & jnp.broadcast_to(tv.arr, (n,))
    return env, valid


def _probe_rowenv(vt: VirtualTable,
                  prep: "_JoinPrep | _VVPrep | None") -> _RowEnv:
    """8-row env for STATIC tag probing (no join executed: dim value
    columns probe as zeros of their tag — tags only depend on dtypes)."""
    idx = jnp.arange(8, dtype=jnp.uint32)
    if prep is None:
        return _gen_env(vt, idx)
    cols = {nm: fn(idx) for nm, fn in vt.columns.items()}
    zero = {"u32": jnp.uint32, "i32": jnp.int32, "f32": jnp.float32}
    for p in prep.val_phys:
        cols[p] = jnp.zeros(8, zero[prep.tags[p]])
    if prep.dim_key_phys is not None:
        cols[prep.dim_key_phys] = jnp.zeros(8, zero[prep.dim_key_tag])
    if prep.matched_phys is not None:
        cols[prep.matched_phys] = jnp.zeros(8, jnp.uint32)
    return _RowEnv(Table(cols), prep.names, prep.tags)


# ---------------------------------------------------------------------------
# JOIN prep: virtual fact x VIRTUAL dimension (both sides out-of-core)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _VVPrep:
    """Resolved virtual x virtual FK join (fused join->GROUP BY).

    Both sides are device-GENERATED, so neither ever crosses the
    host link: phase A sorts each side's (key, index) planes in one
    program (12 B/row resident — the ops/bigjoin residency model),
    phase B plans key-space buckets from union-quantile splitters
    (ops/bigjoin._plan_buckets: all copies of a key land in the same
    bucket on BOTH sides), and each bucket program joins the two
    sorted segments via ops/join.join_fk_scan carrying ONLY the right
    row INDEX through the fill — every referenced dimension column is
    REGENERATED from the joined index afterwards (virtual columns are
    fn(idx): one carried operand no matter how many columns the query
    touches). The joined stream is partially aggregated in the same
    program (the ops/bigpipe shape: only the G-bounded partial table
    leaves each bucket) and the partials merge through the exact host
    combine. Dimension keys are checked UNIQUE once on the sorted
    planes (one-to-many would silently last-win in join_fk_scan's FK
    semantics — 'never silently wrong').

    Reference contrast: the reference pipeline keeps one fixed buffer
    chain on one GPU (/root/reference/src/main.rs:376-688); a
    declarative join of two larger-than-HBM tables is SURVEY.md §5's
    scaled mandate composed with the SQL surface.
    """
    fact_binding: str
    dim_binding: str
    how: str                    # "inner" | "left"
    fact_key: str               # fact column name (in vt.columns)
    fact_key_tag: str
    dim_vt: VirtualTable        # the right (dimension) virtual table
    dim_key: str                # dim column name (in dim_vt.columns)
    val_phys: list              # referenced dim planes "<binding>.<col>"
    val_src: list               # their dim generator column names
    names: dict                 # joined env: ref -> phys
    tags: dict                  # joined env: phys -> tag
    matched_phys: str | None    # "<binding>__matched" (LEFT joins)
    # _probe_rowenv compatibility: the dim key regenerates from the
    # joined row index like any other dim column (never synthesized
    # from the fact key), so no dedicated planes exist
    dim_key_phys: None = None
    dim_key_tag: None = None


def _prep_vv_join(vt: VirtualTable, q: P.Query, db) -> _VVPrep:
    """Resolve a JOIN whose right side is itself a virtual table."""
    sel = q.selects[0]
    j = sel.joins[0]
    if j.how == "full":
        raise SqlError("FULL OUTER JOIN over big tables is not "
                       "supported (unmatched dimension rows need a "
                       "cross-bucket reduction; use LEFT with sides "
                       "swapped where possible)")
    dim_vt = db._virtual[j.table.name.lower()]
    fb, dbind = sel.table.binding, j.table.binding
    if fb == dbind:
        raise SqlError("virtual x virtual self-JOIN needs distinct "
                       "table aliases (FROM t a JOIN t b ON ...)")
    for nm, n_side in ((sel.table.name, vt.n), (j.table.name, dim_vt.n)):
        if n_side > (1 << 29):
            raise SqlError(
                f"virtual x virtual JOIN: side {nm!r} has {n_side} "
                "rows — both sides' (key, index) planes stay resident "
                "(12 B/row) and each side sorts in one program, "
                "bounded at 2^29 rows per side on one chip")

    def fact_side(c: P.Col) -> bool:
        return c.table in (None, fb) and c.name in vt.columns

    def dim_side(c: P.Col) -> bool:
        return c.table in (None, dbind) and c.name in dim_vt.columns

    a, b = j.left_col, j.right_col
    if fact_side(a) and dim_side(b):
        fkey, dkey = a.name, b.name
    elif fact_side(b) and dim_side(a):
        fkey, dkey = b.name, a.name
    else:
        raise SqlError(f"cannot resolve ON {a.key} = {b.key} against "
                       "the fact/dimension columns")

    # referenced dimension columns (pruned: every regenerated plane is
    # live in the bucket program — unreferenced ones are DCE'd, but
    # the env bookkeeping stays minimal)
    refs: list = []
    for it in sel.items:
        if it.expr == "*":
            refs += [P.Col(c, dbind) for c in dim_vt.columns]
        else:
            _walk_cols(it.expr, refs)
    for e in (sel.where, sel.having):
        if e is not None:
            _walk_cols(e, refs)
    for c in sel.group_by:
        refs.append(c)
    for oi in q.order_by:
        refs.append(oi.col)
    want_dim = set()
    for c in refs:
        if c.table == dbind and c.name in dim_vt.columns:
            want_dim.add(c.name)
        elif (c.table is None and c.name in dim_vt.columns
              and c.name not in vt.columns):
            want_dim.add(c.name)

    val_names = sorted(want_dim)
    val_phys = [f"{dbind}.{c}" for c in val_names]
    tags: dict = dict(vt.tags)
    names: dict = {}
    for c in vt.columns:
        names[c] = c
        names[f"{fb}.{c}"] = c
    for c, p in zip(val_names, val_phys):
        tags[p] = dim_vt.tags[c]
        names[p] = p
        if c in vt.columns:
            names.pop(c, None)      # ambiguous bare name
        else:
            names[c] = p
    matched_phys = None
    if j.how == "left":
        matched_phys = f"{dbind}__matched"
        tags[matched_phys] = "u32"
        names[matched_phys] = matched_phys
    return _VVPrep(fb, dbind, j.how, fkey, vt.tags[fkey], dim_vt, dkey,
                   val_phys, val_names, names, tags, matched_phys)


def _vv_sort_side(svt: VirtualTable, keyname: str):
    """One jitted phase-A program: generate the side's join-key column,
    lift to u64 planes, and sort (key, index) — index as the third sort
    key makes the permutation deterministic (unique tie-break)."""
    n = svt.n

    def f():
        idx = jnp.arange(n, dtype=jnp.uint32)
        env = _gen_env(svt, idx)
        tv = env.col(P.Col(keyname))
        k = _lift_key(tv.arr, tv.tag)
        hi, lo, si = jax.lax.sort([k.hi, k.lo, idx], num_keys=3,
                                  is_stable=False)
        return lo, hi, si

    return jax.jit(f)


def _vv_bucket_fn(vt: VirtualTable, vvp: _VVPrep, where, gexprs: list,
                  value_exprs: dict, aggspec: dict, cap_l: int,
                  cap_r: int, gcap: int):
    """One jitted per-bucket program: slice both sorted sides' segments
    (host-clamped starts + offset masks — dynamic_slice clamps OOB
    starts downward, CLAUDE.md), FK-join them carrying only the right
    row index, regenerate every referenced column from the joined
    indices, evaluate WHERE, and partially aggregate. Only the padded
    G-bounded partial table leaves the bucket."""
    from tpu_qe.ops.aggregate import group_aggregate, group_aggregate_multi
    from tpu_qe.ops.join import join_fk_scan
    ones = jnp.uint32(0xFFFFFFFF)

    @jax.jit
    def run(st_l, dl_l, sz_l, st_r, dl_r, sz_r,
            llo, lhi, lidx, rlo, rhi, ridx):
        ar_l = jnp.arange(cap_l, dtype=jnp.uint32)
        ar_r = jnp.arange(cap_r, dtype=jnp.uint32)

        def seg(col, start, cap, delta, size, ar, fill):
            s = jax.lax.dynamic_slice(col, (start,), (cap,))
            d = delta.astype(jnp.uint32)
            return jnp.where(
                (ar >= d) & (ar < d + size.astype(jnp.uint32)), s, fill)

        s_llo = seg(llo, st_l, cap_l, dl_l, sz_l, ar_l, ones)
        s_lhi = seg(lhi, st_l, cap_l, dl_l, sz_l, ar_l, ones)
        s_lidx = seg(lidx, st_l, cap_l, dl_l, sz_l, ar_l, jnp.uint32(0))
        l_valid = (ar_l >= dl_l.astype(jnp.uint32)) & (
            ar_l < dl_l.astype(jnp.uint32) + sz_l.astype(jnp.uint32))
        s_rlo = seg(rlo, st_r, cap_r, dl_r, sz_r, ar_r, ones)
        s_rhi = seg(rhi, st_r, cap_r, dl_r, sz_r, ar_r, ones)
        s_ridx = seg(ridx, st_r, cap_r, dl_r, sz_r, ar_r, jnp.uint32(0))
        r_valid = (ar_r >= dl_r.astype(jnp.uint32)) & (
            ar_r < dl_r.astype(jnp.uint32) + sz_r.astype(jnp.uint32))

        out, matched = join_fk_scan(
            Table({"__lidx": s_lidx}), Table({"__ridx": s_ridx}),
            U64(s_llo, s_lhi), U64(s_rlo, s_rhi),
            l_valid=l_valid, r_valid=r_valid)
        mok = matched & l_valid
        jr = jnp.where(mok, out["__ridx"], jnp.uint32(0))

        cols = {nm: fn(s_lidx) for nm, fn in vt.columns.items()}
        for p, src in zip(vvp.val_phys, vvp.val_src):
            arr = vvp.dim_vt.columns[src](jr)
            # NULL-zero convention for unmatched left rows (LEFT joins)
            cols[p] = jnp.where(mok, arr, jnp.zeros((), arr.dtype))
        if vvp.matched_phys is not None:
            cols[vvp.matched_phys] = mok.astype(jnp.uint32)
        env = _RowEnv(Table(cols), vvp.names, vvp.tags)
        valid = (l_valid & matched) if vvp.how == "inner" else l_valid
        if where is not None:
            tv = _eval(where, env, cap_l)
            if tv.tag != "bool":
                raise SqlError("WHERE must be boolean")
            valid = valid & jnp.broadcast_to(tv.arr, (cap_l,))

        ghi, glo = _group_planes(env, gexprs, cap_l)
        gkey = U64(glo, ghi)
        vals = {}
        for vn, expr in value_exprs.items():
            tv = _eval(expr, env, cap_l)
            arr = tv.arr
            if tv.tag == "bool":
                arr = arr.astype(jnp.uint32)
            if not hasattr(arr, "shape") or arr.shape == ():
                arr = jnp.broadcast_to(arr, (cap_l,))
            vals[vn] = arr
        res = (group_aggregate_multi(gkey, vals, aggspec, valid=valid,
                                     max_groups=gcap)
               if vals else group_aggregate(gkey, aggs=("count",),
                                            valid=valid,
                                            max_groups=gcap))
        return {"klo": res.key.lo, "khi": res.key.hi,
                "ng": res.num_groups, "ovf": res.overflow,
                "aggs": dict(res.aggs or {})}

    return run


def _vv_agg_partials(vt: VirtualTable, vvp: _VVPrep, where,
                     gexprs: list, run_values: dict, aggspec: dict,
                     run_size: int, max_groups: int, sum_signed: dict):
    """Phases A+B+C of the fused virtual x virtual join -> GROUP BY:
    sort both sides' (key, index) planes (one program each), check the
    dimension keys unique, plan key-space buckets, queue every bucket's
    join+aggregate program before the first readback, then combine the
    partial tables exactly on the host. Returns the _agg_partials
    contract: (sorted packed u64 group keys, host agg arrays,
    (compile_s, runs_s, combine_s))."""
    import time as _time
    from tpu_qe.ops.bigjoin import _plan_buckets
    n_l, n_r = vt.n, vvp.dim_vt.n

    np.asarray(jnp.zeros(8, jnp.uint32)[:1])    # device init, untimed
    tc = _time.perf_counter()
    lexec = _vv_sort_side(vt, vvp.fact_key).lower().compile()
    rexec = _vv_sort_side(vvp.dim_vt, vvp.dim_key).lower().compile()
    compile_s = _time.perf_counter() - tc

    ta = _time.perf_counter()
    llo, lhi, lidx = lexec()
    rlo, rhi, ridx = rexec()
    if n_r > 1:
        dup = jax.jit(lambda lo, hi: jnp.any(
            (lo[1:] == lo[:-1]) & (hi[1:] == hi[:-1])))(rlo, rhi)
        if bool(np.asarray(dup)):
            raise SqlError(
                f"dimension join keys ({vvp.dim_key!r}) are not "
                "unique — one-to-many JOIN over big tables is not "
                "supported (the FK join would silently keep one match)")

    mid_compile = 0.0       # compile windows inside the timed region
    n_buckets = max(1, -(-(n_l + n_r) // run_size))
    if n_buckets > 1:
        tcp = _time.perf_counter()
        plan_exec = _plan_buckets.lower(
            llo, lhi, rlo, rhi, n_buckets=n_buckets,
            per_side=8192).compile()
        mid_compile += _time.perf_counter() - tcp
        bl, br = plan_exec(llo, lhi, rlo, rhi)
        bl = np.asarray(bl).astype(np.int64)
        br = np.asarray(br).astype(np.int64)
    else:
        bl = br = np.zeros(0, np.int64)

    def seg_plan(bounds, n):
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [n]])
        return starts, (ends - starts)

    st_l, sz_l = seg_plan(bl, n_l)
    st_r, sz_r = seg_plan(br, n_r)
    quantum = 1 << 20 if max(n_l, n_r) >= (1 << 24) else 256
    cap_l = min(-(-max(int(sz_l.max()), 1) // quantum) * quantum, n_l)
    cap_r = min(-(-max(int(sz_r.max()), 1) // quantum) * quantum, n_r)
    if cap_l + cap_r >= (1 << 30):
        raise SqlError(
            f"virtual x virtual JOIN: one bucket holds {cap_l}+{cap_r} "
            "rows (key skew) — the combined segment must stay below "
            "2^30; reduce run_size to cut more buckets")
    gcap = min(max_groups, cap_l)

    tcb = _time.perf_counter()
    bucket = _vv_bucket_fn(vt, vvp, where, gexprs, run_values, aggspec,
                           cap_l, cap_r, gcap)
    z = jnp.int32(0)
    bexec = bucket.lower(z, z, z, z, z, z, llo, lhi, lidx,
                         rlo, rhi, ridx).compile()
    mid_compile += _time.perf_counter() - tcb

    ceil_l, ceil_r = max(n_l - cap_l, 0), max(n_r - cap_r, 0)
    pend = []
    for b in range(n_buckets):
        cl = min(int(st_l[b]), ceil_l)
        cr = min(int(st_r[b]), ceil_r)
        pend.append(bexec(
            jnp.int32(cl), jnp.int32(st_l[b] - cl), jnp.int32(sz_l[b]),
            jnp.int32(cr), jnp.int32(st_r[b] - cr), jnp.int32(sz_r[b]),
            llo, lhi, lidx, rlo, rhi, ridx))
    parts, tags_of_agg = _read_partials(pend, gcap, sum_signed, "bucket")
    runs_s = _time.perf_counter() - ta - mid_compile
    tb = _time.perf_counter()
    uk, agg_host = _combine_partials(parts, tags_of_agg)
    combine_s = _time.perf_counter() - tb
    return uk, agg_host, (compile_s + mid_compile, runs_s, combine_s)


def _group_key_exprs(vt: VirtualTable, sel: P.Select,
                     prep: _JoinPrep | None = None):
    """Resolve GROUP BY entries (plain columns — fact or joined
    dimension side — or select-item aliases of row expressions,
    sqlite-style) to (exprs, output names, tags). 0 entries = global
    aggregation (one group); 2 entries pack into one U64 (hi = first
    col's sortable bits) exactly like the in-core executor
    (executor.py _grouped)."""
    aliases = {it.alias: it.expr for it in sel.items
               if it.expr != "*" and it.alias
               and not _calls(it.expr, window=False)}
    penv = _probe_rowenv(vt, prep)
    exprs, names, tags = [], [], []
    for c in sel.group_by:
        if c.key in penv.names:
            e = P.Col(c.name, c.table)
        elif c.table is None and c.name in aliases:
            e = aliases[c.name]
        else:
            raise SqlError(f"unknown column {c.key!r}")
        exprs.append(e)
        names.append(c.key)
        tags.append(_expr_tag(vt, e, prep) or "u32")
    if len(exprs) > 2:
        raise SqlError("GROUP BY supports at most two 32-bit columns "
                       "over big tables")
    return exprs, names, tags


def _group_planes(env: _RowEnv, gexprs: list, n: int):
    """(hi, lo) u32 sortable planes of the packed group key — the
    device-side twin of the packing in _group_key_exprs."""
    from tpu_qe.bits import sortable_u32
    planes = []
    for e in gexprs:
        tv = _eval(e, env, n)
        arr = tv.arr
        if tv.tag == "bool":
            arr = arr.astype(jnp.uint32)
        if not hasattr(arr, "shape") or arr.shape == ():
            arr = jnp.broadcast_to(arr, (n,))
        planes.append(sortable_u32(arr))
    z = jnp.zeros(n, jnp.uint32)
    if not planes:
        return z, z
    if len(planes) == 1:
        return z, planes[0]
    return planes[0], planes[1]


def _unpack_group_cols(uk: np.ndarray, gnames: list, gtags: list
                       ) -> dict:
    """Host-side inverse of _group_planes over the combined u64 keys."""
    out = {}
    if len(gnames) == 1:
        out[gnames[0]] = _unlift_key(
            (uk & np.uint64(0xFFFFFFFF)).astype(np.uint32), gtags[0])
    elif len(gnames) == 2:
        out[gnames[0]] = _unlift_key(
            (uk >> np.uint64(32)).astype(np.uint32), gtags[0])
        out[gnames[1]] = _unlift_key(
            (uk & np.uint64(0xFFFFFFFF)).astype(np.uint32), gtags[1])
    return out


def _make_run_fn(vt: VirtualTable, where, gexprs: list, value_exprs: dict,
                 aggspec: dict, run_size: int, cap: int,
                 prep: _JoinPrep | None = None):
    """One jitted program shared by every run (r is a traced scalar;
    the resident dimension planes — if any — ride as the dim arg
    pytree, never closed over: CLAUDE.md HTTP-413 rule)."""
    from tpu_qe.ops.aggregate import group_aggregate, group_aggregate_multi

    def run(r, dim):
        idx = (r * jnp.uint32(run_size)
               + jnp.arange(run_size, dtype=jnp.uint32))
        env, valid = _build_env(vt, prep, where, idx, run_size, dim)
        ghi, glo = _group_planes(env, gexprs, run_size)
        gkey = U64(glo, ghi)
        vals = {}
        for vn, expr in value_exprs.items():
            tv = _eval(expr, env, run_size)
            arr = tv.arr
            if tv.tag == "bool":
                arr = arr.astype(jnp.uint32)
            if not hasattr(arr, "shape") or arr.shape == ():
                arr = jnp.broadcast_to(arr, (run_size,))
            vals[vn] = arr
        res = (group_aggregate_multi(gkey, vals, aggspec, valid=valid,
                                     max_groups=cap)
               if vals else group_aggregate(gkey, aggs=("count",),
                                            valid=valid, max_groups=cap))
        return {"klo": res.key.lo, "khi": res.key.hi,
                "ng": res.num_groups, "ovf": res.overflow,
                "aggs": dict(res.aggs or {})}

    return jax.jit(run)


def _agg_partials(vt: VirtualTable, where, gexprs: list,
                  run_values: dict, aggspec: dict, run_size: int,
                  cap: int, prep: _JoinPrep | None, sum_signed: dict):
    """Phases A+B of a grouped aggregation: run the shared per-run
    partial-aggregation program over every run (queued before the
    first readback, so dispatch round trips do not serialize), with exact per-run overflow detection, then the exact
    host combine. Returns (sorted packed u64 group keys, host agg
    arrays, (compile_s, runs_s, combine_s)). Shared by _agg_big and
    the whole-partition window side channel (_window_big)."""
    import time as _time
    n_runs = (vt.n + run_size - 1) // run_size
    run_fn = _make_run_fn(vt, where, gexprs, run_values, aggspec,
                          run_size, cap, prep)
    dim = prep.dim_dev if prep is not None else {}
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])    # device init, untimed
    tc = _time.perf_counter()
    run_exec = run_fn.lower(jnp.uint32(0), dim).compile()
    compile_s = _time.perf_counter() - tc

    ta = _time.perf_counter()
    pend = [run_exec(jnp.uint32(r), dim) for r in range(n_runs)]
    parts, tags_of_agg = _read_partials(pend, cap, sum_signed, "run")
    runs_s = _time.perf_counter() - ta
    tb = _time.perf_counter()
    uk, agg_host = _combine_partials(parts, tags_of_agg)
    combine_s = _time.perf_counter() - tb
    return uk, agg_host, (compile_s, runs_s, combine_s)


def _read_partials(pend: list, cap: int, sum_signed: dict, what: str):
    """Read back queued partial-table results (the _make_run_fn /
    _vv_bucket_fn output dict shape): exact per-program overflow
    detection, g-bounded head slices, and the agg tag classification
    the host combine needs. Shared by the per-run and the
    virtual x virtual per-bucket aggregation drivers."""
    parts = []
    tags_of_agg: dict[str, str] = {}
    for r, res in enumerate(pend):
        ng = int(np.asarray(res["ng"]))
        if res["ovf"] is not None and int(np.asarray(res["ovf"])):
            raise SqlError(
                f"{what} {r}: more than max_groups={cap} groups per "
                f"{what} — raise max_groups (exact overflow detection, "
                "outputs never silently truncated)")
        klo = _head_np(res["klo"], ng).astype(np.uint64)
        khi = _head_np(res["khi"], ng).astype(np.uint64)
        aggs_np = {}
        for name, arr in res["aggs"].items():
            if isinstance(arr, U64):
                raw = _head_np(arr, ng)
                src = name.rsplit("_", 1)[0]
                signed = sum_signed.get(src, False)
                aggs_np[name] = (raw.view(np.int64) if signed else raw)
                tags_of_agg[name] = "sum_i64" if signed else "sum_u64"
            else:
                aggs_np[name] = _head_np(arr, ng)
                if name.endswith("_count") or name == "count":
                    tags_of_agg[name] = "count"
                elif name.endswith("_sum"):
                    tags_of_agg[name] = "sum_f32"
                elif name.endswith("_min"):
                    tags_of_agg[name] = "min"
                else:
                    tags_of_agg[name] = "max"
        parts.append(((khi << np.uint64(32)) | klo, aggs_np))
    return parts, tags_of_agg


# ---------------------------------------------------------------------------
# phase B: exact host combine of G-bounded partial tables
# ---------------------------------------------------------------------------

def _combine_partials(parts: list, tags_of_agg: dict):
    """np.unique-based merge of per-run partial group tables.

    parts: [(keys u64 np, {agg_name: np array}), ...]. Integer sums are
    u64 (u32 columns, total < 2^64) or i64 (int32 columns, |total| <
    2^63) — both exact in their numpy dtype.
    """
    keys = np.concatenate([k for k, _ in parts])
    uk, inv = np.unique(keys, return_inverse=True)
    g = len(uk)
    out: dict[str, np.ndarray] = {}
    offs = np.cumsum([0] + [len(k) for k, _ in parts])
    for name, kind in tags_of_agg.items():
        if kind in ("count", "sum_u64", "sum_i64"):
            dt = np.int64 if kind == "sum_i64" else np.uint64
            acc = np.zeros(g, dt)
            for (k, aggs), o in zip(parts, offs):
                np.add.at(acc, inv[o:o + len(k)],
                          aggs[name].astype(dt))
            out[name] = acc
        elif kind == "sum_f32":
            acc = np.zeros(g, np.float64)
            for (k, aggs), o in zip(parts, offs):
                np.add.at(acc, inv[o:o + len(k)],
                          aggs[name].astype(np.float64))
            out[name] = acc
        elif kind in ("min", "max"):
            first = parts[0][1][name]
            if first.dtype.kind == "f":
                init = np.inf if kind == "min" else -np.inf
                acc = np.full(g, init, np.float64)
            else:
                info = np.iinfo(first.dtype)
                acc = np.full(g, info.max if kind == "min"
                              else info.min, np.int64)
            red = np.minimum if kind == "min" else np.maximum
            for (k, aggs), o in zip(parts, offs):
                red.at(acc, inv[o:o + len(k)],
                       aggs[name].astype(acc.dtype))
            out[name] = (acc if first.dtype.kind != "f"
                         else acc.astype(np.float32))
        else:
            raise AssertionError(kind)
    return uk, out


# ---------------------------------------------------------------------------
# the out-of-core SELECT
# ---------------------------------------------------------------------------

def select_big(vt: VirtualTable, q: P.Query, run_size: int = 1 << 26,
               max_groups: int = 1 << 16, verbose: bool = False,
               stats: dict | None = None, db=None) -> dict:
    """Execute one parsed query over a virtual table — the dispatcher.

    Verb coverage mirrors the driver tier (each verb runs the matching
    ops/big* machinery shape over the virtual table's generated
    columns; results stay G- or LIMIT-bounded — the readback boundary):

      - GROUP BY (0/1/2 key columns) aggregates + HAVING  -> _agg_big
      - plain SELECT [cols|*] ... LIMIT k                 -> _head_big
      - ORDER BY ... LIMIT k                              -> _orderby_big
      - SELECT DISTINCT / COUNT(DISTINCT)                 -> dedup tier
      - JOIN [+ GROUP BY] (fused, never materialized)     -> join tier
      - window OVER ... LIMIT k                           -> window tier
      - UNION/INTERSECT/EXCEPT                            -> set-op tier

    stats (optional dict): filled with phase timings — compile_s (the
    AOT-compiled run program, excluded from the other numbers per the
    house benching rule), runs_s (phase A dispatch + g-bounded
    readbacks), combine_s (host merge), pct_s (percentile bisection
    rounds incl. their first-use compiles)."""
    if q.set_ops:
        return _setop_big(vt, q, run_size, max_groups, db, stats)
    sel = q.selects[0]
    has_windows = any(_calls(it.expr, window=True)
                      for it in sel.items if it.expr != "*")
    if has_windows:
        return _window_big(vt, q, run_size, max_groups, stats)
    has_aggs = (sel.having is not None
                or any(_calls(it.expr, window=False)
                       for it in sel.items if it.expr != "*"))
    if sel.joins:
        return _join_big_sql(vt, q, run_size, max_groups, db, stats)
    if sel.distinct:
        return _distinct_big(vt, q, run_size, max_groups, stats)
    if sel.group_by or has_aggs:
        return _agg_big(vt, q, run_size, max_groups, verbose, stats)
    if q.order_by:
        return _orderby_big(vt, q, run_size, stats)
    return _head_big(vt, q, run_size, stats=stats)


def _agg_big(vt: VirtualTable, q: P.Query, run_size: int,
             max_groups: int, verbose: bool = False,
             stats: dict | None = None,
             prep: "_JoinPrep | _VVPrep | None" = None) -> dict:
    """GROUP BY (0, 1 or 2 key columns) aggregates over a virtual
    table — the ops/bigagg shape (per-run partials + exact host
    combine; aggregation IS the compression). With prep, every run
    joins its generated fact rows against the resident dimension
    before grouping (the fused join->GROUP BY of ops/bigpipe, here as
    declarative SQL: the joined stream never materializes)."""
    sel = q.selects[0]
    gexprs, gnames, gtags = _group_key_exprs(vt, sel, prep)
    penv = _probe_rowenv(vt, prep)

    # collect aggregate calls (select items + HAVING)
    aggcalls = []
    for it in sel.items:
        if it.expr == "*":
            raise SqlError("SELECT * needs LIMIT over a big table "
                           "(row-scale readback) — aggregate queries "
                           "must name their outputs")
        aggcalls += _calls(it.expr, window=False)
    if sel.having is not None:
        aggcalls += _calls(sel.having, window=False)

    value_exprs: dict[str, object] = {}
    expr_names: dict[str, str] = {}
    pct_specs: dict[tuple, list] = {}     # (vname, kind) -> [(num, sh)]
    pct_of: dict[int, tuple] = {}
    cd_specs: list[str] = []              # COUNT(DISTINCT) value names
    cd_of: dict[int, str] = {}

    def _value_of(arg) -> str:
        if isinstance(arg, P.Col):
            return penv.resolve(arg)    # fact or joined dim column
        rep = repr(arg)
        if rep in expr_names:
            return expr_names[rep]
        if _calls(arg, window=False) or _calls(arg, window=True):
            raise SqlError("nested calls inside aggregate arguments")
        nm = f"__e{len(expr_names)}"
        expr_names[rep] = nm
        value_exprs[nm] = arg
        return nm

    aggspec: dict[str, tuple] = {}
    from tpu_qe.ops.quantile import canon_qs
    for c in aggcalls:
        if c.func in _PCT_FUNCS:
            if c.func == "median":
                if len(c.args) != 1 or c.within_order is not None:
                    raise SqlError("MEDIAN takes one column or "
                                   "expression")
                vn, kind, qq = _value_of(c.args[0]), "disc", (1, 1)
            else:
                if c.within_order is None:
                    raise SqlError(f"{c.func} needs WITHIN GROUP "
                                   "(ORDER BY col)")
                kind = ("disc" if c.func == "percentile_disc"
                        else "cont")
                vn = _value_of(c.within_order)
                (qq,) = canon_qs([float(c.args[0].value)])
            qlist = pct_specs.setdefault((vn, kind), [])
            if qq not in qlist:
                qlist.append(qq)
            pct_of[id(c)] = (vn, kind, qlist.index(qq))
            continue
        if c.func not in _AGG_FUNCS or c.window is not None:
            raise SqlError(f"unknown aggregate {c.func}")
        if c.distinct:
            if c.func != "count":
                raise SqlError(f"{c.func}(DISTINCT) is not supported "
                               "(only COUNT)")
            vn = _value_of(c.args[0])
            if vn not in cd_specs:
                cd_specs.append(vn)
            cd_of[id(c)] = vn
            continue
        if c.func == "count":
            continue
        if len(c.args) != 1:
            raise SqlError(f"{c.func} takes one argument")
        vn = _value_of(c.args[0])
        want = {"avg": ("sum",)}.get(c.func, (c.func,))
        aggspec[vn] = tuple(sorted(set(aggspec.get(vn, ()))
                                   | set(want)))
    for vn in aggspec:
        # physical names round-trip through the env (names[phys]=phys)
        value_exprs.setdefault(vn, P.Col(vn))
    # count always rides (COUNT(*), AVG denominators, HAVING)
    if aggspec:
        first = sorted(aggspec)[0]
        aggspec[first] = tuple(sorted(set(aggspec[first]) | {"count"}))

    n_runs = (vt.n + run_size - 1) // run_size
    if n_runs * run_size >= (1 << 32):
        # idx = r*run_size + arange(run_size) must not wrap u32: wrapped
        # tail indices would pass the `idx < n` mask and double-count
        raise SqlError(f"run_size {run_size} does not tile n={vt.n} "
                       "inside u32 index space — pick a run_size whose "
                       "rounded-up tiling stays below 2^32")
    cap = min(max_groups, run_size)
    # only columns with an aggregate spec enter the run program —
    # percentile-only expressions are (re)generated by the pct phase's
    # own sorted-planes program, never wastefully evaluated here
    import time as _time
    run_values = {vn: value_exprs[vn] for vn in aggspec}
    # static signedness of integer-sum columns, probed ONCE (not per
    # run inside the readback loop)
    sum_signed = {vn: _expr_tag(vt, value_exprs[vn], prep) == "i32"
                  for vn in aggspec}
    if isinstance(prep, _VVPrep):
        if pct_specs or cd_specs:
            raise SqlError(
                "MEDIAN/PERCENTILE/COUNT(DISTINCT) over a virtual x "
                "virtual JOIN is not supported (the bisection and "
                "dedup tiers run over single-table sorted runs)")
        uk, agg_host, (compile_s, runs_s, combine_s) = _vv_agg_partials(
            vt, prep, sel.where, gexprs, run_values, aggspec,
            run_size, max_groups, sum_signed)
    else:
        uk, agg_host, (compile_s, runs_s, combine_s) = _agg_partials(
            vt, sel.where, gexprs, run_values, aggspec, run_size, cap,
            prep, sum_signed)
    g = len(uk)

    # percentiles: bigquantile-shaped bisection over resident runs
    tp = _time.perf_counter()
    pct_host: dict[tuple, np.ndarray] = {}
    pct_compile = [0.0]
    if pct_specs:
        for (vn, kind), qlist in pct_specs.items():
            pct_host.update(_big_group_quantiles(
                vt, sel.where, gexprs, value_exprs.get(vn, P.Col(vn)),
                vn, kind, qlist, uk, run_size, pct_compile, prep))
    cd_host: dict[str, np.ndarray] = {}
    for vn in cd_specs:
        cd_host[vn] = _big_count_distinct(
            vt, sel.where, gexprs, value_exprs.get(vn, P.Col(vn)),
            uk, run_size, cap, prep, pct_compile)
    if stats is not None:
        stats.update(compile_s=stats.get("compile_s", 0.0)
                     + compile_s + pct_compile[0],
                     runs_s=runs_s, combine_s=combine_s,
                     pct_s=_time.perf_counter() - tp - pct_compile[0],
                     n_runs=n_runs, groups=g)

    # host frame: select items / HAVING over the G-bounded arrays
    gvals = _unpack_group_cols(uk, gnames, gtags)
    if aggspec:
        first = sorted(aggspec)[0]
        cnt = agg_host[f"{first}_count"].astype(np.int64)
    else:
        cnt = agg_host["count"].astype(np.int64)

    gexpr_vals = {repr(ge): gvals[gn] for ge, gn in zip(gexprs, gnames)}

    def eval_g(e) -> np.ndarray:
        # a select item may repeat an aliased group expression verbatim
        # (SELECT v % 5 AS m ... GROUP BY m — incl. a plain column
        # aliased into the GROUP BY, e.g. d__matched AS m)
        if not isinstance(e, P.Lit) and repr(e) in gexpr_vals:
            return gexpr_vals[repr(e)]
        if isinstance(e, P.Call):
            if e.func in _PCT_FUNCS:
                return pct_host[pct_of[id(e)]]
            if e.distinct:
                return cd_host[cd_of[id(e)]]
            if e.func == "count":
                return cnt
            vn = _value_of(e.args[0])
            if e.func == "avg":
                s = agg_host[f"{vn}_sum"].astype(np.float64)
                return s / np.maximum(cnt.astype(np.float64), 1)
            return agg_host[f"{vn}_{e.func}"]
        if isinstance(e, P.Col):
            if e.key in gvals:
                return gvals[e.key]
            if e.name in gvals:
                return gvals[e.name]
            raise SqlError(f"column {e.key!r} is not in GROUP BY")
        if isinstance(e, P.Lit):
            return np.asarray(e.value)
        if isinstance(e, P.Unary):
            v = eval_g(e.operand)
            return ~v.astype(bool) if e.op == "not" else -v
        if isinstance(e, P.Binary):
            return _np_binop(e.op, eval_g(e.left), eval_g(e.right))
        raise SqlError(f"unsupported grouped expression "
                       f"{type(e).__name__}")

    keep = np.ones(g, bool)
    if sel.having is not None:
        keep = np.broadcast_to(eval_g(sel.having).astype(bool), (g,))
    from tpu_qe.sql.executor import Database as _Database
    cols, tags = {}, {}
    for i, it in enumerate(sel.items):
        # same auto-naming as the in-core executor (duplicate functions
        # get positional suffixes instead of silently colliding)
        name = it.alias or _Database._auto_name(it.expr, i)
        v = np.broadcast_to(eval_g(it.expr), (g,))
        cols[name] = np.asarray(v)[keep]
        tags[name] = str(cols[name].dtype)
    fr = _frame_order_limit(Frame(cols, tags), q.order_by, q.limit,
                            q.offset)
    return dict(_materialize(fr).cols)


def _expr_tag(vt: VirtualTable, expr, prep: _JoinPrep | None = None
              ) -> str | None:
    """Static tag of an aggregate argument (column tag, or probe an
    expression on 8 generated rows; joined dimension columns probe as
    zeros of their dtype — tags only depend on dtypes)."""
    if expr is None:
        return None
    if prep is None and isinstance(expr, P.Col) and expr.table is None:
        return vt.tags.get(expr.name)
    env = _probe_rowenv(vt, prep)
    tv = _eval(expr, env, 8)
    return "u32" if tv.tag == "bool" else tv.tag


# ---------------------------------------------------------------------------
# out-of-core per-group percentiles: SEGMENT-BOUNDED bisection over
# per-run sorted planes (the bigquantile shape — no merge phase)
# ---------------------------------------------------------------------------

def _big_group_quantiles(vt, where, gexprs, vexpr, vname, kind, qlist,
                         uk: np.ndarray, run_size: int,
                         compile_acc: list | None = None,
                         prep: _JoinPrep | None = None):
    """Exact per-group PERCENTILE over the virtual table.

    Per-run (group hi, group lo, value bits)-sorted planes stay
    RESIDENT; every (group, q) rank resolves by greedy bisection over
    the value's 32 sortable bits (ops/bigquantile.py's selection
    composed with GROUP BY).

    Round-5 rework (VERDICT r4 weak #1): the round-4 version re-ran a
    full 2-plane lexicographic binary search over all n rows for every
    (bit round x run) — ~1.8B gathered elements at XLA take's measured
    68 M elem/s = 54.7 s of a 66.3 s 1B MEDIAN. Now each run's
    per-group segment [start, end) is located ONCE (2-plane searches,
    one program), and every bisection round only binary-searches the
    VALUE plane inside its segment, with the step count sized to the
    largest observed segment (host-read scalar) instead of log2(n):
    balanced 1B/64K-group data pays ~10 single-plane steps instead of
    ~27 two-plane steps per count. Group counts fall out of the
    segment bounds for free (end - start summed over runs).
    """
    from tpu_qe.bits import sortable_u32, sortable_u32_inverse

    g = len(uk)
    n_runs = (vt.n + run_size - 1) // run_size
    uk_lo = jnp.asarray((uk & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    uk_hi = jnp.asarray((uk >> np.uint64(32)).astype(np.uint32))

    # Each run keeps THREE resident u32 planes sorted lexicographically
    # (group hi, group lo, value bits) — no device u64 (house rule).
    # Invalid rows (tail mask / WHERE) sort as all-ones triples to the
    # tail; segment bounds clamp to the valid prefix so even a real
    # all-ones group key with max value bits cannot collide with them.
    @jax.jit
    def run_planes(r, dim):
        idx = (r * jnp.uint32(run_size)
               + jnp.arange(run_size, dtype=jnp.uint32))
        env, valid = _build_env(vt, prep, where, idx, run_size, dim)
        gh, gl = _group_planes(env, gexprs, run_size)
        tv = _eval(vexpr, env, run_size)
        bits = sortable_u32(tv.arr if tv.tag != "bool"
                            else tv.arr.astype(jnp.uint32))
        ones = jnp.uint32(0xFFFFFFFF)
        gh = jnp.where(valid, gh, ones)
        gl = jnp.where(valid, gl, ones)
        vp = jnp.where(valid, bits, ones)
        sgh, sgl, sv = jax.lax.sort([gh, gl, vp], num_keys=3,
                                    is_stable=False)
        n_valid = jnp.sum(valid.astype(jnp.uint32))
        return sgh, sgl, sv, n_valid

    import time as _time
    dim = prep.dim_dev if prep is not None else {}
    tc = _time.perf_counter()
    run_exec = run_planes.lower(jnp.uint32(0), dim).compile()
    c_comp = _time.perf_counter() - tc
    packed_runs = [run_exec(jnp.uint32(r), dim) for r in range(n_runs)]

    def _group_pos(sgh, sgl, n_valid, qh, ql, le: bool):
        """Rank of (qh, ql) among the sorted 2-plane group keys — a
        vectorized binary search (one program-wide setup cost, NOT per
        bisection round). le=False -> first index of the group
        (count of keys strictly below); le=True -> one past its last
        index. Clamped to the valid prefix."""
        n = sgh.shape[0]
        lo_b = jnp.zeros(qh.shape, jnp.uint32)
        hi_b = jnp.full(qh.shape, n, jnp.uint32)

        def body(_, carry):
            lo_b, hi_b = carry
            mid = (lo_b + hi_b) // 2
            i = jnp.minimum(mid, jnp.uint32(n - 1))
            mh, ml = jnp.take(sgh, i), jnp.take(sgl, i)
            if le:
                go = (mh < qh) | ((mh == qh) & (ml <= ql))
            else:
                go = (mh < qh) | ((mh == qh) & (ml < ql))
            open_ = lo_b < hi_b
            lo_b = jnp.where(open_ & go, mid + 1, lo_b)
            hi_b = jnp.where(open_ & ~go, mid, hi_b)
            return lo_b, hi_b

        lo_b, _ = jax.lax.fori_loop(0, n.bit_length() + 1, body,
                                    (lo_b, hi_b))
        return jnp.minimum(lo_b, n_valid)

    @jax.jit
    def segment_bounds(runs_in, qh, ql):
        """(R, G) start/end per (run, group) + per-group total counts
        + the largest segment length (sizes the bisection's static
        step count)."""
        starts, ends = [], []
        for sgh, sgl, sv, nv in runs_in:
            starts.append(_group_pos(sgh, sgl, nv, qh, ql, le=False))
            ends.append(_group_pos(sgh, sgl, nv, qh, ql, le=True))
        starts = jnp.stack(starts)
        ends = jnp.stack(ends)
        seg = ends - starts
        # per-group totals stay exact in u32: a group's count across
        # ALL runs is <= n < 2^32
        return starts, ends, jnp.sum(seg, axis=0), jnp.max(seg)

    tc = _time.perf_counter()
    seg_exec = segment_bounds.lower(packed_runs, uk_hi, uk_lo).compile()
    c_comp += _time.perf_counter() - tc
    starts, ends, cnt_dev, max_seg = seg_exec(packed_runs, uk_hi, uk_lo)
    cnt = np.asarray(cnt_dev).astype(np.int64)
    n_steps = max(int(np.asarray(max_seg)), 1).bit_length() + 1

    def _count_le_seg(sv, start, end, cand):
        """#values <= cand inside [start, end) of one run's sorted
        value plane — single-plane search, n_steps static."""
        n = sv.shape[0]
        lo_b, hi_b = start, end

        def body(_, carry):
            lo_b, hi_b = carry
            mid = (lo_b + hi_b) // 2
            mv = jnp.take(sv, jnp.minimum(mid, jnp.uint32(n - 1)))
            le = mv <= cand
            open_ = lo_b < hi_b
            lo_b = jnp.where(open_ & le, mid + 1, lo_b)
            hi_b = jnp.where(open_ & ~le, mid, hi_b)
            return lo_b, hi_b

        lo_b, _ = jax.lax.fori_loop(0, n_steps, body, (lo_b, hi_b))
        return lo_b - start

    @jax.jit
    def select_ranks_device(runs_in, starts, ends, ranks):
        """Greedy 32-round bisection for the (r+1)-th smallest value
        bit pattern per group, ENTIRELY on device (one dispatch)."""
        def per_bit(j, cand):
            trial = cand | (jnp.uint32(1)
                            << (jnp.uint32(31) - j.astype(jnp.uint32)))
            below = jnp.zeros(ranks.shape, jnp.uint32)
            for i, (sgh, sgl, sv, nv) in enumerate(runs_in):
                below = below + _count_le_seg(
                    sv, starts[i], ends[i], trial - jnp.uint32(1))
            # if strictly-below is still <= rank, the rank element has
            # this bit set
            return jnp.where(below <= ranks, trial, cand)

        return jax.lax.fori_loop(0, 32, per_bit,
                                 jnp.zeros(ranks.shape, jnp.uint32))

    tc = _time.perf_counter()
    sel_exec = select_ranks_device.lower(
        packed_runs, starts, ends, jnp.zeros(g, jnp.uint32)).compile()
    c_comp += _time.perf_counter() - tc
    if compile_acc is not None:
        compile_acc[0] += c_comp

    def rank_of(num, sh):
        r = np.minimum(np.maximum(
            -((-num * cnt) >> sh) - 1, 0), np.maximum(cnt - 1, 0))
        return r

    def select_rank(ranks: np.ndarray) -> np.ndarray:
        assert (ranks < (1 << 32)).all() and (ranks >= 0).all()
        return np.asarray(sel_exec(packed_runs, starts, ends,
                                   jnp.asarray(ranks.astype(np.uint32))))

    vtag = _expr_tag(vt, vexpr, prep) or "u32"

    def unbits(b: np.ndarray) -> np.ndarray:
        return np.asarray(sortable_u32_inverse(jnp.asarray(b),
                                               {"u32": jnp.uint32,
                                                "i32": jnp.int32,
                                                "f32": jnp.float32}[
                                                   vtag]))

    out = {}
    for qi, (num, sh) in enumerate(qlist):
        if kind == "disc":
            ranks = rank_of(num, sh)
            out[(vname, kind, qi)] = unbits(select_rank(ranks))
        else:
            t = num * (cnt - 1)
            fl = t >> sh
            frac = (t - (fl << sh)).astype(np.float64) / (1 << sh)
            lo_v = unbits(select_rank(fl)).astype(np.float64)
            up_v = unbits(select_rank(
                np.minimum(fl + (frac > 0), np.maximum(cnt - 1, 0)))
            ).astype(np.float64)
            out[(vname, kind, qi)] = (lo_v + (up_v - lo_v)
                                      * frac).astype(np.float32)
    return out


def _big_count_distinct(vt, where, gexprs, vexpr, uk: np.ndarray,
                        run_size: int, cap: int,
                        prep: _JoinPrep | None = None,
                        compile_acc: list | None = None) -> np.ndarray:
    """Exact per-group COUNT(DISTINCT expr) over the virtual table.

    ops/bigdistinct's dedup-IS-the-compression invariant composed with
    GROUP BY: each run sorts its (group hi, group lo, value bits)
    triples and compacts the run-distinct pairs to a cap-bounded
    padded prefix (exact overflow detection), then one host pass
    de-duplicates pairs ACROSS runs and counts per group. Value
    distinctness is bit-pattern distinctness of the sortable u32 form
    — identical to the in-core executor's lifted-key dedup.
    """
    from tpu_qe.bits import sortable_u32
    n_runs = (vt.n + run_size - 1) // run_size

    @jax.jit
    def dedup_run(r, dim):
        idx = (r * jnp.uint32(run_size)
               + jnp.arange(run_size, dtype=jnp.uint32))
        env, valid = _build_env(vt, prep, where, idx, run_size, dim)
        gh, gl = _group_planes(env, gexprs, run_size)
        tv = _eval(vexpr, env, run_size)
        arr = tv.arr if tv.tag != "bool" else tv.arr.astype(jnp.uint32)
        if not hasattr(arr, "shape") or arr.shape == ():
            arr = jnp.broadcast_to(arr, (run_size,))
        vb = sortable_u32(arr)
        inv = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))
        sinv, sgh, sgl, sv = jax.lax.sort([inv, gh, gl, vb],
                                          num_keys=4, is_stable=False)
        pos = jnp.arange(run_size, dtype=jnp.uint32)
        prev_h = jnp.concatenate([sgh[:1] ^ jnp.uint32(1), sgh[:-1]])
        prev_l = jnp.concatenate([sgl[:1], sgl[:-1]])
        prev_v = jnp.concatenate([sv[:1], sv[:-1]])
        is_new = ((pos == 0) | (sgh != prev_h) | (sgl != prev_l)
                  | (sv != prev_v)) & (sinv == 0)
        m = jnp.sum(is_new.astype(jnp.uint32))
        packed = jnp.where(is_new, pos, jnp.uint32(0xFFFFFFFF))
        res = jax.lax.sort([packed, sgh, sgl, sv], num_keys=1,
                           is_stable=False)
        return (jax.lax.slice(res[1], (0,), (cap,)),
                jax.lax.slice(res[2], (0,), (cap,)),
                jax.lax.slice(res[3], (0,), (cap,)), m)

    import time as _time
    dim = prep.dim_dev if prep is not None else {}
    tc = _time.perf_counter()
    run_exec = dedup_run.lower(jnp.uint32(0), dim).compile()
    if compile_acc is not None:
        compile_acc[0] += _time.perf_counter() - tc
    parts = [run_exec(jnp.uint32(r), dim) for r in range(n_runs)]
    gs, vs = [], []
    for r, (hh, ll, vv, m) in enumerate(parts):
        mi = int(np.asarray(m))
        if mi > cap:
            raise SqlError(
                f"run {r}: more than max_groups={cap} distinct "
                "(group, value) pairs per run — raise max_groups "
                "(exact overflow detection, outputs never silently "
                "truncated)")
        hi = _head_np(hh, mi).astype(np.uint64)
        lo = _head_np(ll, mi).astype(np.uint64)
        gs.append((hi << np.uint64(32)) | lo)
        vs.append(_head_np(vv, mi).astype(np.uint64))
    g64 = np.concatenate(gs) if gs else np.zeros(0, np.uint64)
    v32 = np.concatenate(vs) if vs else np.zeros(0, np.uint64)
    # cross-run dedup of (group, value) pairs (run-distinct pairs can
    # repeat across runs), then per-group counts aligned to uk
    order = np.lexsort([v32, g64])
    g64, v32 = g64[order], v32[order]
    keep = np.ones(len(g64), bool)
    keep[1:] = (g64[1:] != g64[:-1]) | (v32[1:] != v32[:-1])
    gu, cnts = np.unique(g64[keep], return_counts=True)
    out = np.zeros(len(uk), np.int64)
    out[np.searchsorted(uk, gu)] = cnts
    return out


# ---------------------------------------------------------------------------
# plain SELECT ... LIMIT k over a virtual table (row heads)
# ---------------------------------------------------------------------------

def _select_items(vt: VirtualTable, sel: P.Select,
                  prep: _JoinPrep | None = None):
    """Expand * and auto-name the select list -> [(name, expr), ...].
    With a join, * follows the in-core rule (executor._plain): every
    physical column exactly once — the bare name where unambiguous,
    else the qualified ref."""
    from tpu_qe.sql.executor import Database as _Database
    out = []
    for i, it in enumerate(sel.items):
        if it.expr == "*":
            if prep is None:
                out += [(nm, P.Col(nm)) for nm in vt.columns]
            else:
                bare = {phys for ref, phys in prep.names.items()
                        if "." not in ref}
                for ref, phys in sorted(prep.names.items()):
                    if ("." in ref) == (phys in bare):
                        continue
                    out.append((ref, P.Col(ref)))
        else:
            out.append((it.alias or _Database._auto_name(it.expr, i),
                        it.expr))
    return out


def _emit_rows(vt: VirtualTable, items: list, idx: np.ndarray,
               prep: _JoinPrep | None = None) -> dict:
    """Evaluate the select list at the winning global row indices —
    columns REGENERATE from idx (the virtual-table contract; with a
    join the k-bounded rows RE-JOIN the resident dimension — the FK
    join is deterministic, so regenerated matches equal the scan's),
    so only the k-bounded index set ever crosses the readback
    boundary."""
    m = len(idx)
    dim = prep.dim_dev if prep is not None else {}
    if m == 0:
        env, _ = _build_env(vt, prep, None, jnp.zeros(1, jnp.uint32),
                            1, dim)
        out = {}
        for nm, e in items:
            tv = _eval(e, env, 1)
            a = np.asarray(jnp.broadcast_to(tv.arr, (1,)))[:0]
            out[nm] = a.astype(bool) if tv.tag == "bool" else a
        return out
    env, _ = _build_env(vt, prep, None,
                        jnp.asarray(idx.astype(np.uint32)), m, dim)
    out = {}
    for nm, e in items:
        tv = _eval(e, env, m)
        a = np.asarray(jnp.broadcast_to(tv.arr, (m,)))
        out[nm] = a.astype(bool) if tv.tag == "bool" else a
    return out


def _add_compile_s(stats: dict | None, dt: float) -> None:
    """Accumulate AOT-compile seconds into stats (house timing rule:
    compiles are excluded from benched walls)."""
    if stats is not None:
        stats["compile_s"] = stats.get("compile_s", 0.0) + dt


def _head_big(vt: VirtualTable, q: P.Query, run_size: int,
              prep: _JoinPrep | None = None,
              stats: dict | None = None) -> dict:
    """SELECT [cols|*] FROM big [WHERE p] LIMIT k — the first k
    qualifying rows in row order. Runs scan sequentially and stop as
    soon as k rows are found (readback per run is k-bounded)."""
    sel = q.selects[0]
    if q.limit is None:
        raise SqlError("plain SELECT over a big table needs LIMIT "
                       "(the result would be a row-scale readback; "
                       "aggregate, or add LIMIT)")
    off = q.offset
    k = q.limit + off          # fetch through the offset, emit past it
    items = _select_items(vt, sel, prep)
    if sel.where is None and (prep is None or prep.how == "left"):
        # every row qualifies (LEFT joins keep all fact rows)
        idx = np.arange(min(k, vt.n), dtype=np.uint32)[off:]
        return _emit_rows(vt, items, idx, prep)

    head_cap = min(k, run_size)
    n_runs = (vt.n + run_size - 1) // run_size

    @jax.jit
    def scan_run(r, dim):
        idx = (r * jnp.uint32(run_size)
               + jnp.arange(run_size, dtype=jnp.uint32))
        env, valid = _build_env(vt, prep, sel.where, idx, run_size, dim)
        pos = jnp.arange(run_size, dtype=jnp.uint32)
        key = jnp.where(valid, pos, pos | jnp.uint32(1 << 31))
        _, sidx = jax.lax.sort([key, idx], num_keys=1, is_stable=False)
        m = jnp.sum(valid.astype(jnp.uint32))
        return jax.lax.slice(sidx, (0,), (head_cap,)), m

    dim = prep.dim_dev if prep is not None else {}
    import time as _time
    tc = _time.perf_counter()
    scan_exec = scan_run.lower(jnp.uint32(0), dim).compile()
    _add_compile_s(stats, _time.perf_counter() - tc)
    got: list[np.ndarray] = []
    have = 0
    for r in range(n_runs):
        head, m = scan_exec(jnp.uint32(r), dim)
        take = min(int(np.asarray(m)), k - have)
        if take > 0:
            got.append(_head_np(head, take))
            have += take
        if have >= k:
            break
    idx = (np.concatenate(got).astype(np.uint32) if got
           else np.zeros(0, np.uint32))
    return _emit_rows(vt, items, idx[off:], prep)


# ---------------------------------------------------------------------------
# ORDER BY ... LIMIT k over a virtual table (the ops/bigtopk shape:
# per-run selection composes exactly over runs)
# ---------------------------------------------------------------------------

def _order_exprs(vt: VirtualTable, sel: P.Select, order_by,
                 prep: _JoinPrep | None = None) -> list:
    """Resolve ORDER BY entries (columns — fact or joined dimension
    side — or select aliases) to (expr, desc) pairs."""
    aliases = {it.alias: it.expr for it in sel.items
               if it.expr != "*" and it.alias
               and not _calls(it.expr, window=False)}
    penv = _probe_rowenv(vt, prep)
    out = []
    for oi in order_by:
        c = oi.col
        if c.key in penv.names:
            e = P.Col(c.name, c.table)
        elif c.table is None and c.name in aliases:
            e = aliases[c.name]
        else:
            raise SqlError(f"unknown ORDER BY column {c.key!r}")
        out.append((e, oi.desc))
    return out


def _orderby_big(vt: VirtualTable, q: P.Query, run_size: int,
                 stats: dict | None = None,
                 prep: _JoinPrep | None = None) -> dict:
    """SELECT ... FROM big [WHERE] ORDER BY e1 [DESC], ... LIMIT k.

    ops/bigtopk's selection-composes-over-runs shape generalized to
    multi-column mixed-direction ORDER BY via ops/bigorderby's
    transformed-plane reduction (DESC = inverted sortable bits): each
    run keeps its k best (transformed planes, global idx) — only
    R x k candidates reach the in-core combine, and the winning k
    indices regenerate their output columns (_emit_rows).
    """
    from tpu_qe.bits import sortable_u32
    sel = q.selects[0]
    if q.limit is None:
        raise SqlError("ORDER BY over a big table needs LIMIT "
                       "(row-scale readback; the driver tier "
                       "ops/bigorderby streams full orderings)")
    k = q.limit + q.offset     # fetch through the offset, emit past it
    items = _select_items(vt, sel, prep)
    oexprs = _order_exprs(vt, sel, q.order_by, prep)
    idx, _total = _topk_idx(vt, prep, sel.where, oexprs, k, run_size,
                            stats)
    return _emit_rows(vt, items, idx[q.offset:], prep)


def _topk_idx(vt: VirtualTable, prep: _JoinPrep | None, where,
              oexprs: list, k: int, run_size: int,
              stats: dict | None = None):
    """First k global row indices in the composite (transformed order
    planes, idx) ascending order, WHERE-filtered — the ops/bigtopk
    selection that composes exactly over runs (each run keeps its k
    best; only R x k candidates reach the in-core combine). DESC
    entries invert their sortable bits. With oexprs=[], the composite
    is the global idx alone (row order). Returns (winning idx
    np.uint32 IN composite order, total qualifying rows)."""
    from tpu_qe.bits import sortable_u32
    n_ord = len(oexprs)
    head_cap = min(k, run_size)
    n_runs = (vt.n + run_size - 1) // run_size
    if n_runs * head_cap > (1 << 26):
        raise SqlError(f"LIMIT {k} x {n_runs} runs exceeds the in-core "
                       "candidate combine — lower LIMIT or raise "
                       "run_size")

    @jax.jit
    def run_topk(r, dim):
        idx = (r * jnp.uint32(run_size)
               + jnp.arange(run_size, dtype=jnp.uint32))
        env, valid = _build_env(vt, prep, where, idx, run_size, dim)
        # invalid rows carry all-ones planes AND an all-ones idx so
        # they sort strictly last both inside this run and in the
        # candidate combine (a real idx is <= 2^32 - 2 by the n < 2^32
        # contract, so no valid row can tie a sentinel on every plane)
        ones = jnp.uint32(0xFFFFFFFF)
        planes = []
        for e, desc in oexprs:
            tv = _eval(e, env, run_size)
            arr = tv.arr
            if tv.tag == "bool":
                arr = arr.astype(jnp.uint32)
            if not hasattr(arr, "shape") or arr.shape == ():
                arr = jnp.broadcast_to(arr, (run_size,))
            t = sortable_u32(arr)
            planes.append(jnp.where(valid, ~t if desc else t, ones))
        planes.append(jnp.where(valid, idx, ones))
        srt = jax.lax.sort(planes, num_keys=n_ord + 1, is_stable=False)
        m = jnp.sum(valid.astype(jnp.uint32))
        return (tuple(jax.lax.slice(p, (0,), (head_cap,))
                      for p in srt),
                m)

    dim = prep.dim_dev if prep is not None else {}
    import time as _time
    tc = _time.perf_counter()
    run_exec = run_topk.lower(jnp.uint32(0), dim).compile()
    _add_compile_s(stats, _time.perf_counter() - tc)
    parts = [run_exec(jnp.uint32(r), dim) for r in range(n_runs)]

    # candidate combine on the HOST: the R x head_cap candidate set is
    # LIMIT-bounded (<= 2^26 guarded above, usually tiny), and a host
    # lexsort avoids a per-call device program whose shape depends on
    # n_runs — a fresh compile for every run count
    cat = [np.concatenate([np.asarray(p[0][i]) for p in parts])
           for i in range(n_ord + 1)]
    perm = np.lexsort(cat[::-1])[:k]    # last key primary -> reverse
    total = sum(int(np.asarray(p[1])) for p in parts)
    out_m = min(k, total)
    return cat[-1][perm][:out_m].astype(np.uint32), total


# ---------------------------------------------------------------------------
# SELECT DISTINCT over a virtual table (the ops/bigdistinct shape:
# dedup IS the compression)
# ---------------------------------------------------------------------------

def _distinct_big(vt: VirtualTable, q: P.Query, run_size: int,
                  max_groups: int, stats: dict | None = None,
                  prep: _JoinPrep | None = None) -> dict:
    """SELECT DISTINCT e1[, e2] FROM big [WHERE] [ORDER BY/LIMIT]:
    per-run dedup of the packed (hi, lo) combo planes (only distinct
    combos leave each run, padded to max_groups with exact overflow
    detection) + one host np.unique combine."""
    sel = q.selects[0]
    items = _select_items(vt, sel, prep)
    if not 1 <= len(items) <= 2:
        raise SqlError("SELECT DISTINCT over a big table supports one "
                       "or two 32-bit columns")
    for nm, e in items:
        if _calls(e, window=False) or _calls(e, window=True):
            raise SqlError("SELECT DISTINCT with aggregates over a "
                           "big table is not supported")
    exprs = [e for _, e in items]
    names = [nm for nm, _ in items]
    tags = [_expr_tag(vt, e, prep) or "u32" for e in exprs]
    cap = min(max_groups, run_size)
    n_runs = (vt.n + run_size - 1) // run_size

    @jax.jit
    def dedup_run(r, dim):
        idx = (r * jnp.uint32(run_size)
               + jnp.arange(run_size, dtype=jnp.uint32))
        env, valid = _build_env(vt, prep, sel.where, idx, run_size, dim)
        gh, gl = _group_planes(env, exprs, run_size)
        inv = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))
        sinv, sgh, sgl = jax.lax.sort([inv, gh, gl], num_keys=3,
                                      is_stable=False)
        pos = jnp.arange(run_size, dtype=jnp.uint32)
        prev_h = jnp.concatenate([sgh[:1] ^ jnp.uint32(1), sgh[:-1]])
        prev_l = jnp.concatenate([sgl[:1], sgl[:-1]])
        is_new = ((pos == 0) | (sgh != prev_h) | (sgl != prev_l)) \
            & (sinv == 0)
        m = jnp.sum(is_new.astype(jnp.uint32))
        packed = jnp.where(is_new, pos, jnp.uint32(0xFFFFFFFF))
        res = jax.lax.sort([packed, sgh, sgl], num_keys=1,
                           is_stable=False)
        return (jax.lax.slice(res[1], (0,), (cap,)),
                jax.lax.slice(res[2], (0,), (cap,)), m)

    dim = prep.dim_dev if prep is not None else {}
    import time as _time
    tc = _time.perf_counter()
    run_exec = dedup_run.lower(jnp.uint32(0), dim).compile()
    _add_compile_s(stats, _time.perf_counter() - tc)
    parts = [run_exec(jnp.uint32(r), dim) for r in range(n_runs)]
    combos = []
    for r, (hh, ll, m) in enumerate(parts):
        mi = int(np.asarray(m))
        if mi > cap:
            raise SqlError(
                f"run {r}: more than max_groups={cap} distinct combos "
                "per run — raise max_groups (exact overflow detection, "
                "outputs never silently truncated)")
        hi = _head_np(hh, mi).astype(np.uint64)
        lo = _head_np(ll, mi).astype(np.uint64)
        combos.append((hi << np.uint64(32)) | lo)
    uk = np.unique(np.concatenate(combos)) if combos \
        else np.zeros(0, np.uint64)
    gvals = _unpack_group_cols(uk, names, tags)
    fr = Frame({nm: gvals[nm] for nm in names},
               {nm: str(gvals[nm].dtype) for nm in names})
    fr = _frame_order_limit(fr, q.order_by, q.limit, q.offset)
    return dict(_materialize(fr).cols)


# ---------------------------------------------------------------------------
# tiers wired in subsequent round-5 commits
# ---------------------------------------------------------------------------

def _side_counts_virtual(vtab: VirtualTable, sel: P.Select,
                         run_size: int, cap: int,
                         stats: dict | None = None):
    """One set-op side over a virtual table -> (sorted u64 lifted keys,
    exact i64 multiplicities, np value dtype). ops/bigsetops' shape:
    each run compacts its DISTINCT keys + exact occurrence counts to a
    cap-bounded padded prefix (counts come free from the gaps between
    first-occurrence positions in the sorted run), then one host
    np.unique combine sums counts across runs."""
    expr = sel.items[0].expr
    tag = _expr_tag(vtab, expr) or "u32"
    from tpu_qe.bits import sortable_u32
    n_runs = (vtab.n + run_size - 1) // run_size

    @jax.jit
    def count_run(r):
        idx = (r * jnp.uint32(run_size)
               + jnp.arange(run_size, dtype=jnp.uint32))
        env, valid = _build_env(vtab, None, sel.where, idx, run_size, {})
        tv = _eval(expr, env, run_size)
        arr = tv.arr if tv.tag != "bool" else tv.arr.astype(jnp.uint32)
        if not hasattr(arr, "shape") or arr.shape == ():
            arr = jnp.broadcast_to(arr, (run_size,))
        bits = sortable_u32(arr)
        inv = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))
        sinv, sb = jax.lax.sort([inv, bits], num_keys=2, is_stable=False)
        pos = jnp.arange(run_size, dtype=jnp.uint32)
        prev = jnp.concatenate([sb[:1] ^ jnp.uint32(1), sb[:-1]])
        is_new = ((pos == 0) | (sb != prev)) & (sinv == 0)
        m = jnp.sum(is_new.astype(jnp.uint32))
        n_valid = jnp.sum(valid.astype(jnp.uint32))
        newpos = jnp.where(is_new, pos, jnp.uint32(0xFFFFFFFF))
        st, keys = jax.lax.sort([newpos, sb], num_keys=1,
                                is_stable=False)
        # count of key j = next first-occurrence position - own (the
        # sentinel tail clamps to n_valid, so the last real key's count
        # ends at the valid prefix)
        nxt = jnp.minimum(
            jnp.concatenate([st[1:], jnp.full((1,), 0xFFFFFFFF,
                                              jnp.uint32)]), n_valid)
        cnts = nxt - jnp.minimum(st, n_valid)
        return (jax.lax.slice(keys, (0,), (cap,)),
                jax.lax.slice(cnts, (0,), (cap,)), m)

    import time as _time
    tc = _time.perf_counter()
    run_exec = count_run.lower(jnp.uint32(0)).compile()
    _add_compile_s(stats, _time.perf_counter() - tc)
    parts = [run_exec(jnp.uint32(r)) for r in range(n_runs)]
    ks, cs = [], []
    for r, (kk, cc, m) in enumerate(parts):
        mi = int(np.asarray(m))
        if mi > cap:
            raise SqlError(
                f"set-op side run {r}: more than max_groups={cap} "
                "distinct keys per run — raise max_groups (exact "
                "overflow detection, outputs never silently truncated)")
        ks.append(_head_np(kk, mi).astype(np.uint64))
        cs.append(_head_np(cc, mi).astype(np.int64))
    keys = np.concatenate(ks) if ks else np.zeros(0, np.uint64)
    cnts = np.concatenate(cs) if cs else np.zeros(0, np.int64)
    uk, inv_ = np.unique(keys, return_inverse=True)
    total = np.zeros(len(uk), np.int64)
    np.add.at(total, inv_, cnts)
    if getattr(sel, "distinct", False):
        total = np.ones(len(uk), np.int64)
    dt = {"u32": np.uint32, "i32": np.int32, "f32": np.float32}[tag]
    return uk, total, np.dtype(dt)


def _setop_big(vt, q: P.Query, run_size: int, max_groups: int,
               db, stats: dict | None = None) -> dict:
    """UNION / INTERSECT / EXCEPT [ALL] chains where at least one side
    is a virtual table. Every side compresses to its exact
    (distinct lifted key, multiplicity) table — dedup IS the
    compression (ops/bigsetops) — and the chain folds on the host with
    exact multiset algebra (the same count rules as the in-core
    executor's _set_op: ALL -> sum/min/clamped-difference; else
    presence). Output stays G-bounded until the final expansion, which
    is capped at 2^26 rows (raise, never truncate)."""
    from tpu_qe.sql.executor import (_lift64_np, _unlift64_np,
                                     _materialize as _mat)
    sides = []
    out_name = None
    for si, sel in enumerate(q.selects):
        if (sel.group_by or sel.having is not None or sel.joins
                or any(it.expr == "*" or _calls(it.expr, window=False)
                       or _calls(it.expr, window=True)
                       for it in sel.items)):
            raise SqlError("set-op sides over big tables are plain "
                           "single-column SELECTs (no aggregates, "
                           "joins, or GROUP BY)")
        if len(sel.items) != 1:
            raise SqlError("set operations over big tables support "
                           "single-column selects")
        tname = sel.table.name.lower()
        vside = getattr(db, "_virtual", {}).get(tname) if db else None
        if vside is not None:
            cap = min(max_groups, run_size)
            uk, cnt, dt = _side_counts_virtual(vside, sel, run_size,
                                               cap, stats)
        else:
            if db is None or tname not in db._tables:
                raise SqlError(f"unknown table {sel.table.name!r}")
            fr = _mat(db._select(sel))
            col = fr.cols[next(iter(fr.cols))]
            lifted = _lift64_np(np.asarray(col))
            uk, cnt = np.unique(lifted, return_counts=True)
            cnt = cnt.astype(np.int64)
            if sel.distinct:
                cnt = np.ones(len(uk), np.int64)
            dt = np.asarray(col).dtype
        if out_name is None:
            it = sel.items[0]
            from tpu_qe.sql.executor import Database as _Database
            out_name = it.alias or _Database._auto_name(it.expr, 0)
        sides.append((uk, cnt, dt))

    uk, cnt, dt = sides[0]
    for (op, all_), (ukb, cntb, dtb) in zip(q.set_ops, sides[1:]):
        if dt != dtb:
            raise SqlError(f"{op.upper()}: mismatched column dtypes "
                           f"({dt} vs {dtb})")

        def look(keys, uks, cs):
            i = np.searchsorted(uks, keys)
            i = np.minimum(i, max(len(uks) - 1, 0))
            hit = (uks[i] == keys) if len(uks) else \
                np.zeros(len(keys), bool)
            return np.where(hit, cs[i] if len(cs) else 0, 0)

        if op == "union":
            keys = np.union1d(uk, ukb)
            c = look(keys, uk, cnt) + look(keys, ukb, cntb)
            if not all_:
                c = np.ones(len(keys), np.int64)
        elif op == "intersect":
            keys = np.intersect1d(uk, ukb)
            c = (np.minimum(look(keys, uk, cnt), look(keys, ukb, cntb))
                 if all_ else np.ones(len(keys), np.int64))
        else:                   # except
            c = np.maximum(cnt - look(uk, ukb, cntb), 0) if all_ \
                else np.where(look(uk, ukb, cntb) > 0, 0, 1)
            keep = c > 0
            keys, c = uk[keep], c[keep]
            if not all_:
                c = np.ones(len(keys), np.int64)
        uk, cnt = keys, c.astype(np.int64)

    total = int(cnt.sum())
    if total > (1 << 26):
        raise SqlError(f"set-op result expands to {total} rows — "
                       "exceeds the in-core combine (2^26); narrow "
                       "with WHERE or use non-ALL semantics")
    vals = np.repeat(uk, cnt)
    out = _unlift64_np(vals, dt)
    fr = Frame({out_name: out}, {out_name: str(out.dtype)})
    fr = _frame_order_limit(fr, q.order_by, q.limit, q.offset)
    return dict(_materialize(fr).cols)


def _join_big_sql(vt, q: P.Query, run_size: int, max_groups: int, db,
                  stats: dict | None) -> dict:
    """JOIN over a virtual fact table: resolve the in-core dimension
    once (_prep_join — resident planes, unique-key check), then run
    the matching verb tier with the join threaded through every run
    program. Aggregate queries are the fused join->GROUP BY of
    ops/bigpipe as declarative SQL: the joined stream never
    materializes — each run joins, masks, and partially aggregates in
    ONE jitted program."""
    sel = q.selects[0]
    if (db is not None and len(sel.joins) == 1
            and sel.joins[0].table.name.lower()
            in getattr(db, "_virtual", {})):
        # virtual x virtual: only the fused join->GROUP BY shape exists
        # (row-scale join output over two big sides has no bounded
        # readback; the driver tier streams it — ops/bigjoin consume=)
        has_aggs = (sel.having is not None
                    or any(_calls(it.expr, window=False)
                           for it in sel.items if it.expr != "*"))
        if sel.distinct or not (sel.group_by or has_aggs):
            raise SqlError(
                "virtual x virtual JOIN supports aggregate queries "
                "only (GROUP BY / aggregates — the fused join->GROUP "
                "BY; row-scale join output needs the driver tier's "
                "bucket stream, ops/bigjoin consume=)")
        vvp = _prep_vv_join(vt, q, db)
        return _agg_big(vt, q, run_size, max_groups, stats=stats,
                        prep=vvp)
    prep = _prep_join(vt, q, db, run_size)
    if sel.distinct:
        return _distinct_big(vt, q, run_size, max_groups, stats, prep)
    has_aggs = (sel.having is not None
                or any(_calls(it.expr, window=False)
                       for it in sel.items if it.expr != "*"))
    if sel.group_by or has_aggs:
        return _agg_big(vt, q, run_size, max_groups, stats=stats,
                        prep=prep)
    if q.order_by:
        return _orderby_big(vt, q, run_size, stats, prep)
    return _head_big(vt, q, run_size, prep)


def _np_col(arr, tag) -> np.ndarray:
    """Host view of one window/expression column (U64 running sums
    resolve by tag exactly like executor._materialize)."""
    if isinstance(arr, U64):
        raw = ((np.asarray(arr.hi).astype(np.uint64) << np.uint64(32))
               | np.asarray(arr.lo).astype(np.uint64))
        return raw.view(np.int64) if tag == "i64sum" else raw
    a = np.asarray(arr)
    return a.astype(bool) if tag == "bool" else a


def _window_big(vt: VirtualTable, q: P.Query, run_size: int,
                max_groups: int, stats: dict | None = None) -> dict:
    """Window functions over a virtual table — LIMIT-bounded PREFIX
    exactness composed with G-bounded whole-partition aggregates.

    The first k rows of the composite (PARTITION BY, ORDER BY, idx)
    order form a global prefix of the window stream, and every
    backward-looking window value (row_number / rank / dense_rank, the
    running and moving families, lag, first_value) of a prefix row
    depends only on rows IN that prefix. So the k output rows' values
    are exact after selecting k+F candidate rows with the ops/bigtopk
    composition (_topk_idx; F = the largest LEAD offset — bounded
    forward reach extends the candidate set, only the first k rows are
    emitted) and running the IN-CORE window machinery
    (executor._window_columns, the ops/window.py segmented sweeps)
    over the regenerated candidates. WHERE filters before windows (SQL
    semantics) and the prefix property holds on the filtered stream.

    Whole-partition kinds (COUNT/SUM/MIN/MAX/AVG OVER (PARTITION BY
    ...) with no ORDER BY) are NOT prefix-computable — they ride the
    G-bounded per-group aggregate machinery over the FULL table
    (_agg_partials, exact sums) and join back by packed partition key;
    percent_rank and ntile compose from the prefix-exact
    rank/row_number and the side channel's exact partition sizes (the
    ops/window.py:355-383 formulas). last_value (a whole-partition
    argmax the partial tables do not carry) raises.

    Output rows are IN the composite window order — ORDER BY outside
    OVER raises (the prefix IS an order contract). The driver-tier
    full-stream analogue (every row's window columns at 1B rows, no
    LIMIT) is ops/bigwindow.py's bucket carry chain.
    """
    from tpu_qe.sql.executor import (Database as _D, _lag_args,
                                     _window_kind)
    sel = q.selects[0]
    if sel.joins:
        raise SqlError("window functions with JOIN over a big table "
                       "are not supported")
    if sel.group_by or sel.having is not None:
        raise SqlError("window functions do not mix with GROUP BY")
    if q.limit is None:
        raise SqlError("window functions over a big table need LIMIT "
                       "(row-scale readback otherwise); rows arrive "
                       "in the window's composite (PARTITION BY, "
                       "ORDER BY, idx) order")
    k = q.limit + q.offset     # fetch through the offset, emit past it
    if q.order_by:
        raise SqlError("ORDER BY with big-table windows is not "
                       "supported — output rows follow the window's "
                       "composite (PARTITION BY, ORDER BY, idx) order")

    WHOLE = {"partition_count", "total_sum", "total_min", "total_max",
             "total_avg"}
    COMPOSED = {"percent_rank", "ntile"}
    if any(it.expr == "*" for it in sel.items):
        # SELECT * expands to the virtual table's columns (sorted name
        # order, the register_virtual contract) alongside the windows
        import dataclasses as _dcs
        items = []
        for it in sel.items:
            if it.expr == "*":
                items += [P.SelectItem(P.Col(nm), None)
                          for nm in sorted(vt.columns)]
            else:
                items.append(it)
        sel = _dcs.replace(sel, items=tuple(items))
    wcalls = []
    for it in sel.items:
        cs = _calls(it.expr, window=True)
        if cs:
            if cs[0] is not it.expr:
                raise SqlError("window calls must be top-level select "
                               "items (no arithmetic around them yet)")
            wcalls.append(cs[0])
        elif _calls(it.expr, window=False):
            raise SqlError("aggregates do not mix with window "
                           "functions (add GROUP BY for aggregation)")
    kinds = {id(c): _window_kind(c) for c in wcalls}
    # moving_count with a FOLLOWING bound needs the partition size —
    # it composes like percent_rank (hidden row_number + count side
    # channel); without one it is prefix-exact in-core arithmetic
    mcF = {id(c) for c in wcalls
           if kinds[id(c)] == "moving_count"
           and (c.window.frame_follow or 0) > 0}
    penv = _probe_rowenv(vt, None)

    def pcols_of(c) -> list:
        cols = []
        for p in c.window.partition_by:
            if p.key not in penv.names:
                raise SqlError(f"unknown PARTITION BY column {p.key!r}")
            cols.append(P.Col(p.name, p.table))
        if not 1 <= len(cols) <= 2:
            raise SqlError("PARTITION BY supports one or two 32-bit "
                           "columns over big tables")
        return cols

    RANGEK = {"range_sum", "range_min", "range_max", "range_avg"}
    prefix_calls, whole_calls, range_calls = [], [], []
    for c in wcalls:
        kind = kinds[id(c)]
        if kind.startswith("range_"):
            # tie-aware 'unbounded' frames compose from the prefix +
            # a G-bounded per-(partition, order)-RUN side channel; a
            # numeric bound would need order-value search over the
            # full stream
            if c.window.frame_range != "unbounded":
                raise SqlError("bounded RANGE frames over a big table "
                               "are not supported (an order-VALUE "
                               "bound reaches back an unbounded "
                               "number of rows)")
            if len(c.window.partition_by) != 1:
                raise SqlError("RANGE over a big table supports a "
                               "single PARTITION BY column (the "
                               "per-run side channel packs "
                               "(partition, order) into one u64 key)")
            range_calls.append(c)
            continue
        if kind == "last_value":
            raise SqlError("last_value over a big table is not "
                           "supported (whole-partition argmax)")
        if not c.window.partition_by:
            raise SqlError("OVER () without PARTITION BY is not "
                           "supported")
        (whole_calls if kind in WHOLE else prefix_calls).append(c)

    # the prefix needs ONE composite order (whole-partition aggregates
    # may partition differently — they join back by key)
    spec, F = None, 0
    for c in prefix_calls + range_calls:
        key = (tuple(p.key for p in c.window.partition_by),
               c.window.order_by.key if c.window.order_by else None)
        if spec is None:
            spec = key
        elif key != spec:
            raise SqlError("big-table window calls must share one "
                           "(PARTITION BY, ORDER BY) spec — the "
                           "prefix order contract (whole-partition "
                           "aggregates may differ)")
        if kinds[id(c)] == "lead":
            F = max(F, _lag_args(c)[1])
        if c.window.frame_follow:
            # FOLLOWING frames extend the candidate set's forward
            # reach exactly like LEAD offsets (bounded lookahead)
            F = max(F, c.window.frame_follow)
        if kinds[id(c)] in COMPOSED and c.window.order_by is None:
            raise SqlError(f"{c.func} over a big table needs ORDER BY "
                           "inside OVER")

    if prefix_calls or range_calls:
        c0 = (prefix_calls + range_calls)[0]
        oexprs = [(e, False) for e in pcols_of(c0)]
        ob = c0.window.order_by
        if ob is not None:
            if ob.key not in penv.names:
                raise SqlError(f"unknown OVER ORDER BY column "
                               f"{ob.key!r}")
            oexprs.append((P.Col(ob.name, ob.table), False))
    else:
        oexprs = []                # row (global idx) order
    idx, total = _topk_idx(vt, None, sel.where, oexprs, k + F, run_size,
                           stats)
    m, k_out = len(idx), min(k, total)

    # regenerated candidate env (selection already applied WHERE)
    idx_pad = idx if m else np.zeros(1, np.uint32)
    n_env = len(idx_pad)
    env, _ = _build_env(vt, None, None,
                        jnp.asarray(idx_pad.astype(np.uint32)),
                        n_env, {})

    # prefix-exact columns via the in-core evaluator; COMPOSED kinds
    # get hidden rank/row_number base calls sharing the same spec
    import dataclasses as _dc
    pf_items = [it for it in sel.items
                if _calls(it.expr, window=True)
                and kinds[id(it.expr)] not in WHOLE
                and kinds[id(it.expr)] not in COMPOSED
                and id(it.expr) not in mcF]
    hidden = {}
    for c in wcalls:
        if kinds[id(c)] in COMPOSED or id(c) in mcF:
            if kinds[id(c)] == "ntile" and not (
                    len(c.args) == 1 and isinstance(c.args[0], P.Lit)):
                raise SqlError("ntile takes an integer literal")
            import dataclasses as _dcw
            hidden[id(c)] = P.Call(
                "rank" if kinds[id(c)] == "percent_rank"
                else "row_number", (),
                window=_dcw.replace(c.window, frame_rows=None,
                                    frame_follow=None))
    sel2 = _dc.replace(sel, where=None, items=tuple(pf_items) + tuple(
        P.SelectItem(b, None) for b in hidden.values()))
    wcols = _D._window_columns(sel2, env, n_env) if sel2.items else {}

    # whole-partition / partition-size side channel: G-bounded exact
    # per-group aggregates over the FULL table, joined back by key
    side: dict[int, np.ndarray] = {}
    by_part: dict[tuple, list] = {}
    for c in whole_calls + [c for c in wcalls
                            if kinds[id(c)] in COMPOSED
                            or id(c) in mcF]:
        by_part.setdefault(tuple(p.key for p in c.window.partition_by),
                           []).append(c)
    for pk, cs in by_part.items():
        gexprs = pcols_of(cs[0])
        value_exprs, aggspec, vn_of = {}, {}, {}
        for c in cs:
            kind = kinds[id(c)]
            if (kind == "partition_count" or kind in COMPOSED
                    or id(c) in mcF):
                continue    # partition sizes ride the count agg below
            if len(c.args) != 1 or not isinstance(c.args[0], P.Col):
                raise SqlError(f"{c.func}(...) OVER needs a plain "
                               "column argument")
            vn = penv.resolve(c.args[0])
            vn_of[id(c)] = vn
            want = {"total_sum": ("sum",), "total_min": ("min",),
                    "total_max": ("max",), "total_avg": ("sum",)}[kind]
            aggspec[vn] = tuple(sorted(set(aggspec.get(vn, ()))
                                       | set(want)))
            value_exprs[vn] = P.Col(vn)
        if aggspec:
            first = sorted(aggspec)[0]
            aggspec[first] = tuple(sorted(set(aggspec[first])
                                          | {"count"}))
        cap = min(max_groups, run_size)
        sum_signed = {vn: _expr_tag(vt, value_exprs[vn]) == "i32"
                      for vn in aggspec}
        uk, agg_host, _t = _agg_partials(
            vt, sel.where, gexprs, value_exprs, aggspec, run_size,
            cap, None, sum_signed)
        _add_compile_s(stats, _t[0])
        if aggspec:
            cnt = agg_host[f"{sorted(aggspec)[0]}_count"].astype(
                np.int64)
        else:
            cnt = agg_host["count"].astype(np.int64)
        gh, gl = _group_planes(env, gexprs, n_env)
        packed = ((np.asarray(gh).astype(np.uint64) << np.uint64(32))
                  | np.asarray(gl).astype(np.uint64))
        row_g = np.searchsorted(uk, packed)   # every row's group is
        for c in cs:                          # in uk (same WHERE)
            kind = kinds[id(c)]
            if (kind == "partition_count" or kind in COMPOSED
                    or id(c) in mcF):
                side[id(c)] = cnt[row_g]
                continue
            vn = vn_of[id(c)]
            vtag = _expr_tag(vt, value_exprs[vn])
            if kind == "total_avg":
                s = agg_host[f"{vn}_sum"].astype(np.float64)
                side[id(c)] = (s / np.maximum(
                    cnt.astype(np.float64), 1))[row_g].astype(
                        np.float32)
            elif kind == "total_sum":
                raw = agg_host[f"{vn}_sum"][row_g]
                side[id(c)] = (raw.astype(np.float32)
                               if vtag == "f32" else raw)
            else:               # total_min / total_max (combine
                ag = kind.rsplit("_", 1)[1]     # widened — cast back)
                raw = agg_host[f"{vn}_{ag}"][row_g]
                side[id(c)] = (raw.astype(np.float32)
                               if vtag == "f32"
                               else raw.astype(np.uint32)
                               if vtag == "u32"
                               else raw.astype(np.int32))

    # tie-aware RANGE frames: a prefix row's frame runs through the
    # END of its (partition, order) run, which may extend past the
    # candidate set — compose the prefix-exact cumulative BEFORE the
    # run start (host numpy over the m candidates; every earlier
    # partition row is in the prefix by the order contract) with the
    # run's FULL aggregate from a G-bounded per-RUN side channel
    # (_agg_partials keyed (partition, order) — exact overflow
    # detection bounds distinct runs by max_groups)
    rng_host: dict[int, np.ndarray] = {}
    if range_calls:
        c0r = range_calls[0]
        pr = c0r.window.partition_by[0]
        orr = c0r.window.order_by
        gexprs_r = [P.Col(pr.name, pr.table),
                    P.Col(orr.name, orr.table)]
        value_exprs_r, aggspec_r, vn_of_r = {}, {}, {}
        for c in range_calls:
            kind = kinds[id(c)]
            if len(c.args) != 1 or not isinstance(c.args[0], P.Col):
                raise SqlError(f"{c.func}(...) OVER needs a plain "
                               "column argument")
            vn = penv.resolve(c.args[0])
            vn_of_r[id(c)] = vn
            want = {"range_sum": ("sum",), "range_min": ("min",),
                    "range_max": ("max",), "range_avg": ("sum",)}[kind]
            aggspec_r[vn] = tuple(sorted(set(aggspec_r.get(vn, ()))
                                         | set(want)))
            value_exprs_r[vn] = P.Col(vn)
        first_r = sorted(aggspec_r)[0]
        aggspec_r[first_r] = tuple(sorted(set(aggspec_r[first_r])
                                          | {"count"}))
        cap_r = min(max_groups, run_size)
        sum_signed_r = {vn: _expr_tag(vt, value_exprs_r[vn]) == "i32"
                        for vn in aggspec_r}
        uk_r, agg_r, _tr = _agg_partials(
            vt, sel.where, gexprs_r, value_exprs_r, aggspec_r,
            run_size, cap_r, None, sum_signed_r)
        _add_compile_s(stats, _tr[0])
        cnt_r = agg_r[f"{first_r}_count"].astype(np.int64)
        gh_r, gl_r = _group_planes(env, gexprs_r, n_env)
        hi_part = np.asarray(gh_r).astype(np.uint64)
        packed_r = ((hi_part << np.uint64(32))
                    | np.asarray(gl_r).astype(np.uint64))
        row_r = np.searchsorted(uk_r, packed_r)
        fi = np.zeros(n_env, bool)
        fi[0] = True
        run_new = fi.copy()
        run_new[1:] = packed_r[1:] != packed_r[:-1]
        part_new = fi.copy()
        part_new[1:] = hi_part[1:] != hi_part[:-1]
        run_id = np.cumsum(run_new) - 1
        part_id = np.cumsum(part_new) - 1
        run_starts = np.flatnonzero(run_new)
        part_starts = np.flatnonzero(part_new)
        rs_row = run_starts[run_id]          # my run's start row
        ps_row = part_starts[part_id]        # my partition's start row
        cnt_before = (rs_row - ps_row).astype(np.int64)
        for c in range_calls:
            kind = kinds[id(c)]
            vn = vn_of_r[id(c)]
            vtag = _expr_tag(vt, value_exprs_r[vn])
            v_np = np.asarray(_eval(value_exprs_r[vn], env, n_env).arr)
            if kind in ("range_sum", "range_avg"):
                run_tot = agg_r[f"{vn}_sum"][row_r]
                acc_dt = np.float64 if vtag == "f32" else np.int64
                cv = np.cumsum(v_np.astype(acc_dt))
                before_all = cv - v_np.astype(acc_dt)
                pre = before_all[rs_row] - before_all[ps_row]
                if kind == "range_sum":
                    tot = pre + run_tot.astype(acc_dt)
                    rng_host[id(c)] = (tot.astype(np.float32)
                                       if vtag == "f32"
                                       else tot.astype(np.int64))
                else:
                    den = np.maximum(cnt_before + cnt_r[row_r], 1)
                    rng_host[id(c)] = (
                        (pre.astype(np.float64)
                         + run_tot.astype(np.float64))
                        / den.astype(np.float64)).astype(np.float32)
            else:
                ag = kind.rsplit("_", 1)[1]
                op = np.minimum if ag == "min" else np.maximum
                run_m = agg_r[f"{vn}_{ag}"][row_r]
                wide = v_np.astype(np.float64 if vtag == "f32"
                                   else np.int64)
                acc = wide.copy()
                for s_, e_ in zip(part_starts,
                                  np.append(part_starts[1:], n_env)):
                    acc[s_:e_] = op.accumulate(wide[s_:e_])
                has_pre = rs_row > ps_row
                pre_m = acc[np.maximum(rs_row - 1, 0)]
                comb = np.where(has_pre,
                                op(pre_m, run_m.astype(acc.dtype)),
                                run_m.astype(acc.dtype))
                rng_host[id(c)] = (comb.astype(np.float32)
                                   if vtag == "f32"
                                   else comb.astype(np.uint32)
                                   if vtag == "u32"
                                   else comb.astype(np.int32))

    # emission: first k rows of the composite order
    out = {}
    for i, it in enumerate(sel.items):
        name = it.alias or _D._auto_name(it.expr, i)
        cs = _calls(it.expr, window=True)
        if cs:
            c = cs[0]
            kind = kinds[id(c)]
            if kind in RANGEK:
                v = rng_host[id(c)]
            elif id(c) in mcF:
                # frame count with FOLLOWING reach: the forward clamp
                # needs the partition's FULL size (side channel), the
                # backward clamp is prefix-exact row_number arithmetic
                pc_full = side[id(c)].astype(np.int64)
                rn = _np_col(*wcols[id(hidden[id(c)])]).astype(np.int64)
                fr_ = c.window.frame_rows
                fo_ = c.window.frame_follow or 0
                back = rn if fr_ is None else np.minimum(rn, fr_ + 1)
                v = (back + np.minimum(pc_full - rn, fo_)).astype(
                    np.uint32)
            elif kind in WHOLE:
                v = side[id(c)]
            elif kind in COMPOSED:
                cnt_full = side[id(c)].astype(np.int64)
                base = _np_col(*wcols[id(hidden[id(c)])]).astype(
                    np.int64)
                if kind == "percent_rank":
                    den = np.maximum(cnt_full - 1, 1).astype(
                        np.float64)
                    v = ((base - 1) / den).astype(np.float32)
                else:           # ntile(t): ops/window.py:366-372
                    t = int(c.args[0].value)
                    rn0 = base - 1
                    qq, rr = cnt_full // t, cnt_full % t
                    big = rr * (qq + 1)
                    v = (np.where(rn0 < big, rn0 // (qq + 1),
                                  rr + (rn0 - big) // np.maximum(qq, 1))
                         + 1).astype(np.uint32)
            else:
                v = _np_col(*wcols[id(c)])
        else:
            tv = _eval(it.expr, env, n_env)
            v = _np_col(jnp.broadcast_to(tv.arr, (n_env,)), tv.tag)
        out[name] = np.asarray(v)[q.offset:k_out]
    return out
