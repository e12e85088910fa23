"""Filter / stream compaction over columnar tables.

Selection under jit: static shapes are mandatory, so a filter
returns the same-length table with all selected rows compacted (stably) to
the front plus the selected-row count — the vectorized "selection vector"
formulation. Compaction rides the engine's sorting machinery (a 1-bit-key
stable sort is a stable two-way partition, the same primitive as one radix
split in the sort pipeline).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from tpu_qe.bits import U64
from tpu_qe.table import Table


@jax.jit
def compact(table: Table, mask: jnp.ndarray) -> tuple[Table, jnp.ndarray]:
    """Stably move rows where mask is True to the front.

    Returns (table, count): rows [0, count) are the selected rows in their
    original order; rows beyond are the unselected rows (also stable).
    """
    n = mask.shape[0]
    assert n < (1 << 31), n
    # keep/drop packs into bit 31 over the unique row index: order within
    # each side is row order (stability) and the sort runs unstable.
    drop = jnp.where(mask, jnp.uint32(0), jnp.uint32(1 << 31))
    key = drop | jnp.arange(n, dtype=jnp.uint32)
    cols = []
    names = []
    shapes: list[str] = []
    for name in table:
        c = table[name]
        if isinstance(c, U64):
            cols += [c.lo, c.hi]
            shapes.append("u64")
        else:
            cols.append(c)
            shapes.append("one")
        names.append(name)
    res = jax.lax.sort([key] + cols, num_keys=1, is_stable=False)
    out_cols = list(res[1:])
    rebuilt = {}
    i = 0
    for name, kind in zip(names, shapes):
        if kind == "u64":
            rebuilt[name] = U64(out_cols[i], out_cols[i + 1])
            i += 2
        else:
            rebuilt[name] = out_cols[i]
            i += 1
    count = jnp.sum(mask.astype(jnp.uint32))
    return Table(rebuilt), count


def filter_table(table: Table, predicate: Callable[[Table], jnp.ndarray]):
    """Filter by a row predicate: predicate(table) -> bool mask."""
    return compact(table, predicate(table))
