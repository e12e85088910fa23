"""64-bit keys as (lo, hi) uint32 pairs.

The engine keeps x64 off, so u64 sort keys are carried as
two uint32 arrays — the same representation the reference uses on the GPU
(morton code buffers hold u64 as 2xu32, reference src/main.rs:60-74).

All functions are jit-safe and shape-polymorphic.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np


class U64(NamedTuple):
    """A u64 array as (lo, hi) uint32 pair — a jax pytree."""

    lo: jnp.ndarray
    hi: jnp.ndarray

    @property
    def shape(self):
        return self.lo.shape

    @staticmethod
    def from_numpy(x: np.ndarray) -> "U64":
        x = np.asarray(x, dtype=np.uint64)
        return U64(
            jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
        )

    def to_numpy(self) -> np.ndarray:
        lo = np.asarray(self.lo).astype(np.uint64)
        hi = np.asarray(self.hi).astype(np.uint64)
        return lo | (hi << np.uint64(32))


def masked_key(lo: jnp.ndarray, hi: jnp.ndarray, key_bits: int) -> U64:
    """Zero all bits above `key_bits` — the reference's select_bits mask used
    by its sortedness verifier (/root/reference/src/main.rs:1042-1051)."""
    if key_bits >= 64:
        return U64(lo, hi)
    if key_bits <= 32:
        m = jnp.uint32((1 << key_bits) - 1) if key_bits < 32 else jnp.uint32(0xFFFFFFFF)
        return U64(lo & m, jnp.zeros_like(hi))
    m = jnp.uint32((1 << (key_bits - 32)) - 1)
    return U64(lo, hi & m)


def is_sorted_u64(lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Non-decreasing check on u64 pairs (jit-safe, returns scalar bool)."""
    if lo.shape[0] < 2:
        return jnp.bool_(True)
    hi_prev, hi_next = hi[:-1], hi[1:]
    lo_prev, lo_next = lo[:-1], lo[1:]
    ok = (hi_prev < hi_next) | ((hi_prev == hi_next) & (lo_prev <= lo_next))
    return jnp.all(ok)


def pack_columns(cols: Sequence[jnp.ndarray]) -> list[jnp.ndarray]:
    """Normalize payload columns to uint32 bit patterns for sorting."""
    out = []
    for c in cols:
        if c.dtype == jnp.float32:
            out.append(jnp.asarray(c).view(jnp.uint32))
        elif c.dtype in (jnp.uint32, jnp.int32):
            out.append(c.view(jnp.uint32) if c.dtype == jnp.int32 else c)
        else:
            raise TypeError(f"unsupported payload dtype {c.dtype}")
    return out


def sortable_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Bit pattern whose UNSIGNED u32 order matches the value order.

    IEEE total-order trick for float32 (flip sign bit on positives,
    invert negatives), sign-bit flip for int32, identity for uint32.
    A bijection — see sortable_u32_inverse. Equality is preserved, so
    boundary/equality checks on the transformed plane are exact.
    """
    if x.dtype == jnp.float32:
        b = x.view(jnp.uint32)
        sign = b >> 31
        return jnp.where(sign == 1, ~b, b | jnp.uint32(0x80000000))
    if x.dtype == jnp.int32:
        return x.view(jnp.uint32) ^ jnp.uint32(0x80000000)
    if x.dtype == jnp.uint32:
        return x
    raise TypeError(f"unsupported sort-key dtype {x.dtype}")


def sortable_u32_inverse(b: jnp.ndarray, dtype) -> jnp.ndarray:
    """Inverse of sortable_u32: recover the original values from bits."""
    if dtype == jnp.float32:
        was_positive = (b >> 31) == 1
        return jnp.where(was_positive, b ^ jnp.uint32(0x80000000),
                         ~b).view(jnp.float32)
    if dtype == jnp.int32:
        return (b ^ jnp.uint32(0x80000000)).view(jnp.int32)
    return b


def mul_u32_wide(a: jnp.ndarray, b) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact widening u32 x u32 -> u64 multiply as a (lo, hi) u32 pair.

    16-bit limb decomposition with explicit carries (x64 stays off, so
    there is no native u64 multiply). b may be a scalar.
    """
    b = jnp.uint32(b) if not hasattr(b, "dtype") else b
    a0, a1 = a & jnp.uint32(0xFFFF), a >> 16
    b0, b1 = b & jnp.uint32(0xFFFF), b >> 16
    p00 = a0 * b0                       # < 2^32, exact
    p01 = a0 * b1                       # < 2^32, exact
    p10 = a1 * b0                       # < 2^32, exact
    p11 = a1 * b1                       # < 2^32, exact
    mid = p01 + (p00 >> 16)             # < 2^32 (no carry possible)
    mid2 = mid + p10                    # may wrap: carry below
    carry = (mid2 < p10).astype(jnp.uint32)
    lo = (p00 & jnp.uint32(0xFFFF)) | (mid2 << 16)
    hi = p11 + (mid2 >> 16) + (carry << 16)
    return lo, hi
