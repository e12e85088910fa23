"""Top-k selection over columnar tables (ORDER BY ... LIMIT k).

Implementation is a full stable sort + head: exact, stable and simple.
The alternatives — XLA's TopK HLO (lax.top_k) and a sampled threshold +
stable compaction + tiny sort — were not faster on the accelerator this
engine was first written for, where compaction was itself a sort. Which
is fastest on a given device is an open measurement.

The reference has no query operators; this extends SURVEY §7's operator
mandate (filter / aggregate / join) with the ORDER BY ... LIMIT shape on
the same sorting machinery.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_qe.bits import U64
from tpu_qe.table import Table


class TopKResult(NamedTuple):
    table: Table   # k rows, best first (includes the key column)


def _flatten(table: Table):
    cols, names, kinds = [], [], []
    for name in table:
        c = table[name]
        if isinstance(c, U64):
            cols += [c.lo, c.hi]
            kinds.append("u64")
        else:
            cols.append(c.view(jnp.uint32) if c.dtype != jnp.uint32 else c)
            kinds.append(str(c.dtype))
        names.append(name)
    return cols, names, kinds


def _rebuild(out_cols, names, kinds):
    rebuilt = {}
    i = 0
    for name, kind in zip(names, kinds):
        if kind == "u64":
            rebuilt[name] = U64(out_cols[i], out_cols[i + 1])
            i += 2
        else:
            c = out_cols[i]
            rebuilt[name] = c.view(kind) if kind != "uint32" else c
            i += 1
    return Table(rebuilt)


@functools.partial(jax.jit, static_argnames=("k", "largest"))
def _top_k_impl(lo, hi, cols: tuple, k: int, largest: bool):
    n = lo.shape[0]
    wlo = ~lo if largest else lo
    whi = ~hi if largest else hi
    idx = jnp.arange(n, dtype=jnp.uint32)
    # unstable 3-key sort with the unique index as tiebreak == the stable
    # result, cheaper (the engine's xla_tiebreak backend rationale)
    res = jax.lax.sort([whi, wlo, idx] + list(cols), num_keys=3,
                       is_stable=False)
    o_hi, o_lo = res[0][:k], res[1][:k]
    o_lo = ~o_lo if largest else o_lo
    o_hi = ~o_hi if largest else o_hi
    return (o_lo, o_hi) + tuple(r[:k] for r in res[3:])


def top_k(table: Table, k: int, key: str = "key",
          largest: bool = False) -> TopKResult:
    """k rows with the smallest (default) or largest u64 `key`.

    Rows are returned best-first; ties broken by original row order
    (deterministic, identical to a stable full sort + head).
    """
    kcol = table[key]
    assert isinstance(kcol, U64), "top_k key must be u64"
    n = table.num_rows
    if not (0 < k <= n):
        raise ValueError(f"k must be in (0, {n}]: {k}")
    rest = table.drop(key)
    cols, names, kinds = _flatten(rest)
    out = _top_k_impl(kcol.lo, kcol.hi, tuple(cols), k, largest)
    body = _rebuild(list(out[2:]), names, kinds)
    return TopKResult(body.with_column(key, U64(out[0], out[1])))
