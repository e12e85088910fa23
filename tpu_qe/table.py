"""Columnar HBM-resident tables.

The reference's "tables" are structure-of-array GPU buffers (vertices,
triangle indices, morton codes — /root/reference/src/types.rs:1-45); this is
the generalized columnar container the query operators work over. A Table is
a pytree, so it passes through jit/shard_map/vmap transparently.

Column types: uint32 / int32 / float32 arrays, or U64 (a (lo, hi) uint32
pair) for 64-bit keys such as morton codes.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.bits import U64

Column = jnp.ndarray | U64


@jax.tree_util.register_pytree_node_class
class Table:
    """Immutable named-column table."""

    def __init__(self, columns: Mapping[str, Column]):
        self._cols = dict(columns)
        lens = {self._len(c) for c in self._cols.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged columns: { {k: self._len(v) for k, v in self._cols.items()} }")

    @staticmethod
    def _len(c: Column) -> int:
        return c.lo.shape[0] if isinstance(c, U64) else c.shape[0]

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        names = sorted(self._cols)
        return tuple(self._cols[n] for n in names), tuple(names)

    @classmethod
    def tree_unflatten(cls, names, cols):
        # JAX rebuilds pytrees with arbitrary placeholder leaves (tracers,
        # scalars, None) — the validating __init__ must not run here.
        obj = object.__new__(cls)
        obj._cols = dict(zip(names, cols))
        return obj

    # -- basic access ---------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._len(next(iter(self._cols.values()))) if self._cols else 0

    @property
    def column_names(self) -> list[str]:
        return sorted(self._cols)

    def __getitem__(self, name: str) -> Column:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._cols))

    def select(self, *names: str) -> "Table":
        return Table({n: self._cols[n] for n in names})

    def with_column(self, name: str, col: Column) -> "Table":
        cols = dict(self._cols)
        cols[name] = col
        return Table(cols)

    def drop(self, *names: str) -> "Table":
        return Table({k: v for k, v in self._cols.items() if k not in names})

    # -- conversion -----------------------------------------------------------
    @staticmethod
    def from_numpy(columns: Mapping[str, np.ndarray]) -> "Table":
        cols: dict[str, Column] = {}
        for k, v in columns.items():
            v = np.asarray(v)
            if v.dtype == np.uint64:
                cols[k] = U64.from_numpy(v)
            elif v.dtype in (np.uint32, np.int32, np.float32):
                cols[k] = jnp.asarray(v)
            else:
                raise TypeError(f"column {k}: unsupported dtype {v.dtype}")
        return Table(cols)

    def to_numpy(self) -> dict[str, np.ndarray]:
        out = {}
        for k, v in self._cols.items():
            out[k] = v.to_numpy() if isinstance(v, U64) else np.asarray(v)
        return out

    def take(self, idx: jnp.ndarray) -> "Table":
        """Row gather (jit-safe)."""
        def g(c):
            if isinstance(c, U64):
                return U64(jnp.take(c.lo, idx), jnp.take(c.hi, idx))
            return jnp.take(c, idx)
        return Table({k: g(v) for k, v in self._cols.items()})

    def head(self, n: int) -> "Table":
        def h(c):
            if isinstance(c, U64):
                return U64(c.lo[:n], c.hi[:n])
            return c[:n]
        return Table({k: h(v) for k, v in self._cols.items()})

    # -- query-operator conveniences ------------------------------------------
    def sort_by(self, key: str, backend: str = "xla") -> "Table":
        """Rows reordered by ascending u64 key column (stable)."""
        from tpu_qe.sort import sort_u64
        k = self._cols[key]
        if not isinstance(k, U64):
            raise TypeError(f"sort key {key!r} must be u64")
        names, payloads, kinds = [], [], []
        for n, c in self._cols.items():
            if n == key:
                continue
            names.append(n)
            if isinstance(c, U64):
                payloads += [c.lo, c.hi]
                kinds.append("u64")
            else:
                payloads.append(c.view(jnp.uint32)
                                if c.dtype != jnp.uint32 else c)
                kinds.append(str(c.dtype))
        skey, spay = sort_u64(k, *payloads, backend=backend)
        cols: dict[str, Column] = {key: skey}
        i = 0
        for n, kind in zip(names, kinds):
            if kind == "u64":
                cols[n] = U64(spay[i], spay[i + 1])
                i += 2
            else:
                c = spay[i]
                cols[n] = c.view(kind) if kind != "uint32" else c
                i += 1
        return Table(cols)

    def order_by(self, *by) -> "Table":
        """Multi-column SQL ORDER BY (stable): items are "name" or
        ("name", "asc"|"desc"); keys may be U64/uint32/int32/float32.
        One lexicographic lax.sort (ops/orderby.py)."""
        from tpu_qe.ops.orderby import sort_by_multi
        if len(by) == 1 and not isinstance(by[0], (str, tuple)):
            by = tuple(by[0])  # accept a single list/iterable too
        return sort_by_multi(self, by)

    def filter(self, predicate) -> tuple["Table", "jnp.ndarray"]:
        """Stable compaction of rows where predicate(self) is True.

        Returns (table, count): rows [0, count) are the selected rows.
        """
        from tpu_qe.ops.filter import filter_table
        return filter_table(self, predicate)

    def distinct(self, key: str = "key"):
        """SELECT DISTINCT key: unique u64 keys, ascending, padded —
        returns (U64 keys, exact num scalar). The GROUP BY boundary
        machinery with no aggregates."""
        from tpu_qe.ops.aggregate import group_aggregate
        k = self._cols[key]
        if not isinstance(k, U64):
            raise TypeError(f"distinct key {key!r} must be u64")
        res = group_aggregate(k, aggs=("count",))
        return res.key, res.num_groups

    def group_by(self, key: str, value: str | None = None,
                 aggs=("count",)):
        """Sort-based GROUP BY over a u64 key column. aggs may include
        "count_distinct" (SQL's COUNT(DISTINCT value))."""
        from tpu_qe.ops.aggregate import group_aggregate
        k = self._cols[key]
        if not isinstance(k, U64):
            raise TypeError(f"group key {key!r} must be u64")
        v = None if value is None else self._cols[value]
        return group_aggregate(k, v, aggs=tuple(aggs))

    def group_by_multi(self, key: str, aggs: dict,
                       valid=None, max_groups: int | None = None):
        """Multi-column GROUP BY: aggs = {column_name: (agg, ...)}."""
        from tpu_qe.ops.aggregate import group_aggregate_multi
        k = self._cols[key]
        if not isinstance(k, U64):
            raise TypeError(f"group key {key!r} must be u64")
        values = {nm: self._cols[nm] for nm in aggs}
        return group_aggregate_multi(k, values, aggs, valid=valid,
                                     max_groups=max_groups)

    def join(self, right: "Table", key: str = "key"):
        """FK equi-join against `right` on a shared u64 key column."""
        from tpu_qe.ops.join import join_fk_scan
        lkey, rkey = self._cols[key], right[key]
        if not (isinstance(lkey, U64) and isinstance(rkey, U64)):
            raise TypeError("join key must be u64 on both sides")
        return join_fk_scan(self.drop(key), right.drop(key), lkey, rkey)

    def join_inner(self, right: "Table", key: str = "key",
                   out_budget: int | None = None):
        """One-to-many inner equi-join (duplicate right keys allowed):
        materializes every match pair into a static padded budget with an
        exact count + overflow flag (ops.join.join_inner)."""
        from tpu_qe.ops.join import join_inner
        return join_inner(self, right, key=key, out_budget=out_budget)

    def join_outer(self, right: "Table", key: str = "key",
                   how: str = "left", out_budget: int | None = None):
        """One-to-many LEFT/FULL OUTER equi-join: unmatched left rows
        keep one slot with matched=False + zeroed right columns; FULL
        adds a padded right_only section (ops.join.join_outer)."""
        from tpu_qe.ops.join import join_outer
        return join_outer(self, right, key=key, how=how,
                          out_budget=out_budget)

    def join_semi(self, right: "Table", key: str = "key"):
        """Semi join: my rows whose key appears in `right`, stably
        compacted to the front. Returns (table, count). Only the right
        KEY column enters the probe (value columns would ride two
        full-stream sorts just to be discarded)."""
        _, matched = self.join(right.select(key), key=key)
        from tpu_qe.ops.filter import compact
        return compact(self, matched)

    def join_anti(self, right: "Table", key: str = "key"):
        """Anti join: my rows whose key does NOT appear in `right`,
        stably compacted to the front. Returns (table, count). Only the
        right KEY column enters the probe."""
        _, matched = self.join(right.select(key), key=key)
        from tpu_qe.ops.filter import compact
        return compact(self, ~matched)

    def window(self, key: str, funcs: dict,
               order: str | None = None) -> "Table":
        """Window functions OVER (PARTITION BY key [ORDER BY order]):
        returns this table plus one new column per entry of `funcs`
        (rows stay in input order). funcs spec per ops.window.window,
        e.g. {"rn": ("row_number",), "cum": ("running_sum", "gain")}."""
        from tpu_qe.ops.window import window
        k = self._cols[key]
        if not isinstance(k, U64):
            raise TypeError(f"window partition key {key!r} must be u64")
        for name in funcs:
            if name in self._cols:
                raise ValueError(f"output column {name!r} already exists")
        needed = {f[1] for f in (tuple(v) if not isinstance(v, str)
                                 else (v,) for v in funcs.values())
                  if len(f) > 1}
        res = window(k, funcs,
                     order=None if order is None else self._cols[order],
                     values={nm: self._cols[nm] for nm in needed})
        cols = dict(self._cols)
        cols.update(res.cols)
        return Table(cols)

    def set_op(self, other: "Table", op: str, key: str = "key"):
        """SQL UNION / INTERSECT / EXCEPT (distinct) over a shared u64
        key column. Returns (keys, count_self, count_other, num) —
        ops.setops.set_op."""
        from tpu_qe.ops.setops import set_op
        k, ok = self._cols[key], other[key]
        if not (isinstance(k, U64) and isinstance(ok, U64)):
            raise TypeError(f"set-op key {key!r} must be u64 on both sides")
        return set_op(k, ok, op)

    def quantile(self, qs, key: str = "key"):
        """Exact global PERCENTILE_DISC over a column (U64 or
        u32/i32/f32); qs per ops.quantile.canon_qs."""
        from tpu_qe.ops.quantile import quantile
        return quantile(self._cols[key], qs)

    def group_quantile(self, key: str, value: str, qs,
                       max_groups: int | None = None):
        """Per-group exact PERCENTILE_DISC: GROUP BY key over value.
        max_groups bounds the extraction (ops/quantile.py) — pass it
        when the cardinality is known; the rank gathers then cost
        O(max_groups) instead of O(n)."""
        from tpu_qe.ops.quantile import group_quantile
        k = self._cols[key]
        if not isinstance(k, U64):
            raise TypeError(f"group key {key!r} must be u64")
        return group_quantile(k, self._cols[value], qs,
                              max_groups=max_groups)

    def quantile_cont(self, qs, key: str = "key"):
        """Exact global PERCENTILE_CONT (lower/upper/frac exact; f32
        interpolation for 32-bit numeric columns)."""
        from tpu_qe.ops.quantile import quantile_cont
        return quantile_cont(self._cols[key], qs)

    def group_quantile_cont(self, key: str, value: str, qs,
                            max_groups: int | None = None):
        """Per-group exact PERCENTILE_CONT: GROUP BY key over value."""
        from tpu_qe.ops.quantile import group_quantile_cont
        k = self._cols[key]
        if not isinstance(k, U64):
            raise TypeError(f"group key {key!r} must be u64")
        return group_quantile_cont(k, self._cols[value], qs,
                                   max_groups=max_groups)

    def top_k(self, k: int, key: str = "key", largest: bool = False):
        """k rows with the smallest/largest u64 key, best first (stable
        full sort + head; see ops/topk.py)."""
        from tpu_qe.ops.topk import top_k
        return top_k(self, k, key=key, largest=largest)

    def save(self, path: str, format: str = "npz") -> str:
        """Persist to disk (format: 'npz' single-file or 'orbax' dir)."""
        from tpu_qe.utils import checkpoint as ckpt
        if format == "npz":
            return ckpt.save_table_npz(self, path)
        if format == "orbax":
            return ckpt.save_table(self, path)
        raise ValueError(f"unknown format {format!r}")

    @staticmethod
    def load(path: str, format: str = "npz") -> "Table":
        """Load a Table persisted with save()."""
        from tpu_qe.utils import checkpoint as ckpt
        if format == "npz":
            return ckpt.load_table_npz(path)
        if format == "orbax":
            return ckpt.load_table(path)
        raise ValueError(f"unknown format {format!r}")

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{k}: {'u64' if isinstance(v, U64) else v.dtype}"
            for k, v in sorted(self._cols.items()))
        return f"Table[{self.num_rows} rows]({parts})"
