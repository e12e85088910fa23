"""Bitonic merge of pre-sorted runs (used by the dsort overlap path).

Merging k sorted runs pairwise costs O(log n) compare-exchange passes per
round instead of the O(log^2 n) of re-sorting. The overlapped distributed
sort uses this as its non-overlappable tail. The jnp-level stages pay
relayout copies, so the out-of-core bucket combine uses one lax.sort
instead; this network is only worth it where pipelining against
collectives (not stage count) is the objective.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lex_le3(a, b):
    """Lexicographic a <= b over (hi, lo, rank) u32 column triples."""
    ah, al, ar = a[0], a[1], a[2]
    bh, bl, br = b[0], b[1], b[2]
    return ((ah < bh)
            | ((ah == bh) & ((al < bl)
                             | ((al == bl) & (ar <= br)))))


def bitonic_merge_cols(A, B):
    """Merge two column sets, each ascending by (hi, lo, rank), into one.

    Columns are [hi, lo, rank, *payloads]; both runs must have the same
    power-of-two length. concat(A, reverse(B)) is bitonic; half-cleaner
    stages sort it.

    Lowering: strides >= 256 are ROW operations on a
    (rows, 2, s/128, 128) view, so no multi-million-element dimension
    lands in the minor position, and once every remaining stride is
    < 256 the element MEMBERSHIP of each aligned 256-window is final, so
    the tail of the network collapses into one batched lax.sort over
    (L/256, 256) windows.
    """
    m = A[0].shape[0]
    assert m == B[0].shape[0] and (m & (m - 1)) == 0, (m, B[0].shape)
    nk = min(3, len(A))
    cols = [jnp.concatenate([a, b[::-1]]) for a, b in zip(A, B)]
    total = 2 * m
    if total >= 512:
        s = m
        while s >= 256:
            parts = [c.reshape(-1, 2, s // 128, 128) for c in cols]
            a = [p[:, 0] for p in parts]
            b = [p[:, 1] for p in parts]
            a_le_b = lex_le3(a, b)
            low = [jnp.where(a_le_b, x, y) for x, y in zip(a, b)]
            high = [jnp.where(a_le_b, y, x) for x, y in zip(a, b)]
            cols = [jnp.stack([l, h], axis=1).reshape(-1)
                    for l, h in zip(low, high)]
            s //= 2
        view = [c.reshape(-1, 256) for c in cols]
        res = jax.lax.sort(view, num_keys=nk, is_stable=False)
        cols = [c.reshape(-1) for c in res]
    else:
        res = jax.lax.sort(cols, num_keys=nk, is_stable=False)
        cols = list(res)
    return cols


def merge_tree(runs):
    """Merge a power-of-two list of sorted runs into one sorted run."""
    assert len(runs) & (len(runs) - 1) == 0, len(runs)
    while len(runs) > 1:
        runs = [bitonic_merge_cols(runs[i], runs[i + 1])
                for i in range(0, len(runs), 2)]
    return runs[0]
