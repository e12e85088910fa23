"""Multi-column ORDER BY: one lexicographic sort over mixed-type keys.

SQL's `ORDER BY a DESC, b ASC, c` over a columnar Table as ONE
`lax.sort` with `num_keys` — the comparison-sort core the whole engine
rides.
Each key column contributes its order-preserving u32 bit planes
(tpu_qe.bits.sortable_u32; U64 keys contribute hi then lo), DESC inverts
the plane bits (~x reverses unsigned order — a bijection, undone on
output), and the unique input position rides as the FINAL key so SQL's
stable tie-break comes from an UNSTABLE sort (the house pattern, see
ops/window.py).

Reference contrast: the reference sorts a single u64 morton plane
(/root/reference/src/main.rs:60-74); multi-key ordering is part of the
engine's SQL surface beyond it (SURVEY.md §2c extensions).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu_qe.bits import U64, sortable_u32, sortable_u32_inverse
from tpu_qe.table import Table


def canon_by(by) -> tuple[tuple[str, bool], ...]:
    """Normalize the ORDER BY spec: items are "name" or ("name", dir)
    with dir in {"asc", "desc"}. Returns ((name, descending), ...)."""
    out = []
    for item in ([by] if isinstance(by, str) else list(by)):
        if isinstance(item, str):
            out.append((item, False))
            continue
        name, d = item
        if d not in ("asc", "desc"):
            raise ValueError(f"direction must be 'asc'|'desc', got {d!r}")
        out.append((name, d == "desc"))
    if not out:
        raise ValueError("ORDER BY needs at least one key column")
    names = [nm for nm, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate ORDER BY column in {names}")
    return tuple(out)


def key_planes(table: Table, spec) -> tuple[list, list]:
    """Transformed u32 key planes (major -> minor) + per-plane metadata
    [(colname, which, dtype, descending)] for reconstruction; `which`
    is "hi"/"lo" for U64 planes, None for scalar columns."""
    planes, meta = [], []
    for name, desc in spec:
        c = table[name]
        if isinstance(c, U64):
            for which, p in (("hi", c.hi), ("lo", c.lo)):
                planes.append(~p if desc else p)
                meta.append((name, which, None, desc))
        else:
            b = sortable_u32(c)
            planes.append(~b if desc else b)
            meta.append((name, None, c.dtype, desc))
    return planes, meta


def reconstruct_keys(sorted_planes, meta) -> dict:
    """Invert key_planes over the sorted planes: {name: column}."""
    cols: dict = {}
    halves: dict = {}
    for p, (name, which, dtype, desc) in zip(sorted_planes, meta):
        b = ~p if desc else p
        if which is not None:
            halves.setdefault(name, {})[which] = b
            if len(halves[name]) == 2:
                cols[name] = U64(halves[name]["lo"], halves[name]["hi"])
        else:
            cols[name] = sortable_u32_inverse(b, dtype)
    return cols


@functools.partial(jax.jit, static_argnames=("num_keys",))
def _sort_planes(planes_and_payloads, num_keys: int):
    return jax.lax.sort(planes_and_payloads, num_keys=num_keys,
                        is_stable=False)


def sort_by_multi(table: Table, by) -> Table:
    """Rows reordered by the multi-column ORDER BY spec (stable).

    by: "name", or a sequence of "name" / ("name", "asc"|"desc").
    Key columns may be U64, uint32, int32, or float32 (float order is
    IEEE: -inf < ... < inf < nan-bit-patterns). All other columns ride
    as payload. Stability (input order among ties) is exact via the
    position key.
    """
    spec = canon_by(by)
    planes, meta = key_planes(table, spec)
    n = table.num_rows
    if n == 0:
        return table
    assert n < (1 << 32), n
    pos = jnp.arange(n, dtype=jnp.uint32)
    key_names = {nm for nm, _ in spec}
    pay_names, payloads, kinds = [], [], []
    for nm in table:
        if nm in key_names:
            continue
        c = table[nm]
        pay_names.append(nm)
        if isinstance(c, U64):
            payloads += [c.lo, c.hi]
            kinds.append("u64")
        else:
            payloads.append(c.view(jnp.uint32)
                            if c.dtype != jnp.uint32 else c)
            kinds.append(str(c.dtype))
    res = _sort_planes(tuple(planes) + (pos,) + tuple(payloads),
                       num_keys=len(planes) + 1)
    cols = reconstruct_keys(res[: len(planes)], meta)
    i = len(planes) + 1
    for nm, kind in zip(pay_names, kinds):
        if kind == "u64":
            cols[nm] = U64(res[i], res[i + 1])
            i += 2
        else:
            c = res[i]
            cols[nm] = c.view(kind) if kind != "uint32" else c
            i += 1
    return Table({nm: cols[nm] for nm in table})
