"""Two-level blocked inclusive scan for segmented monoids.

The engine's segmented sweeps (join forward-fill, per-segment reductions,
exact u64 pair sums) were flat Hillis-Steele strided loops: log2(n) full
memory passes over every carried plane — 28 passes at n=2^28. Each step
depends on the last, so XLA cannot fuse them; the traffic is real.

This module folds the same associative combine in TWO levels:

  1. reshape to (B, C) blocks and scan ALONG THE MINOR AXIS — log2(C)
     full passes give every row its in-block inclusive prefix;
  2. an exclusive scan of the B block summaries (log2(B) passes over
     n/C-sized arrays — negligible traffic for C >= 256);
  3. ONE combine pass applies each block's carry to its rows.

Total traffic ~ (log2(C) + 1) full passes + epsilon: C=1024 turns 28
passes into 11 at 256M rows — the same O(n log C + (n/C) log(n/C)) work a
classic two-level segmented scan does on any vector machine, expressed in
XLA ops (no gather, no scatter, no associative_scan).

Correctness needs only what the flat loop already assumed: `combine` is
associative up to don't-care values (value planes are consumed only where
the fill flag is set), and `idents` are left identities in the same
up-to-don't-cares sense. The association order differs from the flat
loop's, so bit-exactness across the two paths holds for the engine's
integer/flag monoids (tests assert equality); FLOAT sums may round
differently between paths — both orders are valid segmented sums with
per-segment-proportional error.

Reference contrast: the reference's only scan is the 3-dispatch
hierarchical Blelloch cascade over 256-wide GPU workgroups
(/root/reference/src/main.rs:200-233, src/shaders/radix_sort_block_sum_*);
this is the same blocking idea applied at HBM scale, where the "block" is
sized to amortize pass traffic rather than shared memory.
"""

from __future__ import annotations

import jax.numpy as jnp

# 1024 keeps the summary scan's traffic < 1% of one full pass at any n
# this engine runs.
BLOCK = 1024


def _shifted(state, idents, stride: int, axis: int):
    outs = []
    for x, i in zip(state, idents):
        if axis == 0:
            pad = jnp.full((stride,) + x.shape[1:], i, x.dtype)
            outs.append(jnp.concatenate([pad, x[:-stride]]))
        else:
            pad = jnp.full((x.shape[0], stride), i, x.dtype)
            outs.append(jnp.concatenate([pad, x[:, :-stride]], axis=1))
    return tuple(outs)


def _strided(combine, idents, state, length: int, axis: int):
    """Flat Hillis-Steele inclusive scan along `axis` (0 or minor=1)."""
    stride = 1
    while stride < length:
        state = combine(_shifted(state, idents, stride, axis), state)
        stride *= 2
    return state


def scan_assoc(combine, idents, state, block: int = BLOCK):
    """Inclusive scan of a tuple-of-arrays state under `combine`.

    combine((a0, a1, ...), (b0, b1, ...)) -> tuple, `a` the EARLIER
    prefix; idents are per-plane left-identity scalars. All planes share
    one leading length n; results are bit-identical to the flat strided
    loop for flag/integer monoids (see module docstring for floats).
    """
    state = tuple(state)
    n = state[0].shape[0]
    if n <= 4 * block:
        return _strided(combine, idents, state, n, axis=0)
    nb = -(-n // block)
    npad = nb * block
    if npad > n:
        state = tuple(
            jnp.concatenate([x, jnp.full((npad - n,), i, x.dtype)])
            for x, i in zip(state, idents))
    state = tuple(x.reshape(nb, block) for x in state)
    state = _strided(combine, idents, state, block, axis=1)
    # exclusive cross-block carry: shift summaries down one block, scan
    sums = tuple(x[:, -1] for x in state)
    sums = _shifted(sums, idents, 1, axis=0)
    carry = _strided(combine, idents, sums, nb, axis=0)
    carry = tuple(jnp.broadcast_to(c[:, None], (nb, block)) for c in carry)
    state = combine(carry, state)
    return tuple(x.reshape(npad)[:n] for x in state)


# ---------------------------------------------------------------- wrappers
# Unsegmented cumulative ops through the same blocked machinery; whether
# XLA's own jnp.cumsum / lax.cummax beat them on a given device is an
# open measurement.


def cumsum_u32(v: jnp.ndarray) -> jnp.ndarray:
    """Inclusive wrapping u32 cumsum (bit-identical to jnp.cumsum)."""
    (out,) = scan_assoc(lambda a, b: (a[0] + b[0],), (0,), (v,))
    return out


def cummax_u32(v: jnp.ndarray) -> jnp.ndarray:
    """Inclusive running max (bit-identical to lax.cummax)."""
    (out,) = scan_assoc(lambda a, b: (jnp.maximum(a[0], b[0]),), (0,), (v,))
    return out


def cumsum_u64_pair(v: jnp.ndarray, vhi: jnp.ndarray | None = None):
    """Inclusive EXACT u64 prefix sum of u32 values as (lo, hi) planes.

    lo is the wrapping u32 cumsum; hi counts the wraps: each added value
    is < 2^32 so an add wraps at most once, and it wrapped iff the new lo
    is smaller than the addend — hi reconstructs the exact 64-bit prefix
    sum (exact while n < 2^32). This is how integer GROUP BY sums stay
    exact past 2^32 without 64-bit arithmetic (x64 stays off).
    One blocked scan of the carry monoid replaces the two chained
    jnp.cumsum passes — u64 addition is associative, so the result is
    bit-identical to the flat pair.

    vhi: optional per-element hi-word inputs. With vhi = 0xFFFFFFFF on
    negative rows (sign extension), int32 inputs sum EXACTLY as signed
    values in two's complement mod 2^64 — the same carry monoid, since
    pair addition is u64 addition regardless of what the hi plane
    encodes."""

    def combine(a, b):
        lo = a[0] + b[0]
        return (lo, a[1] + b[1] + (lo < b[0]).astype(jnp.uint32))

    lo, hi = scan_assoc(combine, (0, 0),
                        (v.astype(jnp.uint32),
                         jnp.zeros(v.shape, jnp.uint32)
                         if vhi is None else vhi))
    return lo, hi
