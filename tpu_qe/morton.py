"""Extended-morton encoding on the device (JAX).

Equivalent of the reference's morton kernel (morton_code.wgsl:91-335): per
triangle, gather 3 vertices, compute the AABB, quantize the centroid to
20-bit cells and the AABB diagonal to a 12-bit size index, then build the
64-bit extended morton key.

Two key-construction paths are provided:

- ``encode_quantized`` (default): direct bit-interleave — a handful of
  elementwise shift/or ops per element that XLA fuses, with no table
  lookups.
- ``encode_quantized_lut``: the reference's LUT formulation (9 groups x 256
  bytes + 4096-entry size LUT, morton_code.wgsl:42-46,113-126), used to
  validate LUT semantics against the native builder and kept for parity.

Bit layout is defined in tpu_qe/cpp/core.cc (coord_bit_position /
size_bit_position) and mirrored here; tests assert exact agreement.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from tpu_qe import native
from tpu_qe.bits import U64, mul_u32_wide
from tpu_qe.constants import COORD_BITS, SIZE_BITS, SIZE_INDEX_BITS

_COORD_MAX = (1 << COORD_BITS) - 1
_SIZE_INDEX_MAX = (1 << SIZE_INDEX_BITS) - 1


def coord_bit_position(level: int, axis: int) -> int:
    """Output bit (63=MSB) for coordinate level (0=most significant) + axis."""
    return 63 - ((level // 5) * 16 + (level % 5) * 3 + axis)


def size_bit_position(bit: int) -> int:
    return 16 * bit


class MortonParams(NamedTuple):
    """Device-side morton uniforms (reference MortonUniforms, types.rs:46-54)."""

    offset: jnp.ndarray           # (3,) f32
    multiplier: jnp.ndarray       # (3,) f32
    size_multiplier: jnp.ndarray  # () f32
    lut_lo: jnp.ndarray           # (9, 256) u32
    lut_hi: jnp.ndarray           # (9, 256) u32
    size_lut_lo: jnp.ndarray      # (4096,) u32
    size_lut_hi: jnp.ndarray      # (4096,) u32

    @staticmethod
    def from_native(gen: "native.MortonGen") -> "MortonParams":
        lut = gen.lut  # (9, 256) u64
        return MortonParams(
            offset=jnp.asarray(gen.offset, dtype=jnp.float32),
            multiplier=jnp.asarray(gen.multiplier, dtype=jnp.float32),
            size_multiplier=jnp.float32(gen.size_multiplier),
            lut_lo=jnp.asarray((lut & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            lut_hi=jnp.asarray((lut >> np.uint64(32)).astype(np.uint32)),
            size_lut_lo=jnp.asarray(
                (gen.size_lut & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            size_lut_hi=jnp.asarray(
                (gen.size_lut >> np.uint64(32)).astype(np.uint32)),
        )

    @staticmethod
    def for_scene(scene_min, scene_max) -> "MortonParams":
        return MortonParams.from_native(
            native.MortonGen(np.asarray(scene_min), np.asarray(scene_max)))


def _rounded(x: jnp.ndarray) -> jnp.ndarray:
    """x, rounded to f32 before its consumer sees it.

    An identity for finite x that keeps XLA's fused code from contracting
    a multiply into the add that follows it: an FMA rounds once where the
    -ffp-contract=off C++ oracle rounds twice, which moves cells at
    quantization boundaries. ``optimization_barrier`` does not do this on
    the CPU and GPU backends, which expand it before fusion.
    """
    return jnp.minimum(x, jnp.float32(np.finfo(np.float32).max))


def round_sqrt(x: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """The correctly rounded f32 sqrt of x, from an estimate s within two
    ulps of it (the C++ oracle's sqrtf is correctly rounded; the GPU's
    sqrt can be an ulp off).

    Starting two ulps below s, a candidate c = C * 2^(ec-150) steps up
    while x lies above the square of its upper rounding midpoint
    (2C+1) * 2^(ec-151). With x = X * 2^(ex-150) that test is the integer
    comparison X * 2^(ex - 2ec + 152) > (2C+1)^2, both below 2^54 and
    never equal (the right side is odd and wider than 24 bits).
    Zero, denormal and non-finite x keep s.
    """
    xb = x.view(jnp.uint32)
    ex = (xb >> 23).astype(jnp.int32)
    big = (xb & jnp.uint32(0x7FFFFF)) | jnp.uint32(0x800000)
    normal = (ex >= 1) & (ex <= 254)
    r = s.view(jnp.uint32) - jnp.uint32(2)
    for _ in range(4):
        ec = (r >> 23).astype(jnp.int32)
        m = (((r & jnp.uint32(0x7FFFFF)) | jnp.uint32(0x800000))
             << 1) | jnp.uint32(1)
        mlo, mhi = mul_u32_wide(m, m)
        k = jnp.clip(ex - 2 * ec + 152, 1, 31).astype(jnp.uint32)
        xlo, xhi = big << k, big >> (jnp.uint32(32) - k)
        up = normal & ((xhi > mhi) | ((xhi == mhi) & (xlo > mlo)))
        r = r + up.astype(jnp.uint32)
    return jnp.where(normal, r.view(jnp.float32), s)


def quantize(verts: jnp.ndarray, tris: jnp.ndarray,
             params: MortonParams) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Quantize triangle centroids/sizes.

    Float op order matches morton_code.wgsl:109-110 exactly:
    ``((min + max) * 0.5 - offset) * multiplier - 0.001`` and
    ``length(max - min) * size_multiplier``, with clamping conversion.

    Returns (q (T,3) u32 cell coords, j (T,) u32 size index).
    """
    v0 = jnp.take(verts, tris[:, 0], axis=0)
    v1 = jnp.take(verts, tris[:, 1], axis=0)
    v2 = jnp.take(verts, tris[:, 2], axis=0)
    mn = jnp.minimum(jnp.minimum(v0, v1), v2)
    mx = jnp.maximum(jnp.maximum(v0, v1), v2)
    c = (mn + mx) * jnp.float32(0.5)
    prod = _rounded((c - params.offset) * params.multiplier)
    val = prod - jnp.float32(0.001)
    q = jnp.clip(val, 0.0, float(_COORD_MAX)).astype(jnp.uint32)
    ext = mx - mn
    sq = _rounded(ext * ext)
    l2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
    length = round_sqrt(l2, jnp.sqrt(l2))
    j = jnp.clip(length * params.size_multiplier, 0.0,
                 float(_SIZE_INDEX_MAX)).astype(jnp.uint32)
    return q, j


def encode_quantized(q: jnp.ndarray, j: jnp.ndarray) -> U64:
    """Direct bit-interleave of quantized cells: (T,3) u32 + (T,) u32 -> U64."""
    lo = jnp.zeros(q.shape[0], dtype=jnp.uint32)
    hi = jnp.zeros(q.shape[0], dtype=jnp.uint32)
    for axis in range(3):
        col = q[:, axis]
        for level in range(COORD_BITS):
            src_bit = COORD_BITS - 1 - level
            pos = coord_bit_position(level, axis)
            bit = (col >> src_bit) & jnp.uint32(1)
            if pos < 32:
                lo = lo | (bit << pos)
            else:
                hi = hi | (bit << (pos - 32))
    s = j >> (SIZE_INDEX_BITS - SIZE_BITS)
    for b in range(SIZE_BITS):
        pos = size_bit_position(b)
        bit = (s >> b) & jnp.uint32(1)
        if pos < 32:
            lo = lo | (bit << pos)
        else:
            hi = hi | (bit << (pos - 32))
    return U64(lo, hi)


def encode_quantized_lut(q: jnp.ndarray, j: jnp.ndarray,
                         params: MortonParams,
                         quirk_shift: bool = False) -> U64:
    """LUT-path key construction (parity with morton_code.wgsl:111-126).

    quirk_shift=False (default) resolves the byte-shift quirk at :72-74
    to 8*level (the layout the 9-group LUT implies); quirk_shift=True is
    FAITHFUL to the shipped kernel's i*3 shift, reproducing the shipped
    binary's codes given identical LUT content (only coordinate bits
    0..13 reach the key; byte windows overlap).
    """
    lo = jnp.zeros(q.shape[0], dtype=jnp.uint32)
    hi = jnp.zeros(q.shape[0], dtype=jnp.uint32)
    step = 3 if quirk_shift else 8
    for level in range(3):
        for axis in range(3):
            byte = (q[:, axis] >> (step * level)) & jnp.uint32(0xFF)
            grp = axis + 3 * level
            lo = lo | jnp.take(params.lut_lo[grp], byte)
            hi = hi | jnp.take(params.lut_hi[grp], byte)
    jj = j & jnp.uint32(_SIZE_INDEX_MAX)
    lo = lo | jnp.take(params.size_lut_lo, jj)
    hi = hi | jnp.take(params.size_lut_hi, jj)
    return U64(lo, hi)


def encode(verts: jnp.ndarray, tris: jnp.ndarray, params: MortonParams,
           use_lut: bool = False, quirk_lut: bool = False) -> U64:
    """Full morton encoding: gather + quantize + key construction."""
    q, j = quantize(verts, tris, params)
    if use_lut or quirk_lut:
        return encode_quantized_lut(q, j, params, quirk_shift=quirk_lut)
    return encode_quantized(q, j)


def quantize_points(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray,
                    size: jnp.ndarray | None,
                    params: MortonParams) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Quantize columnar points (the scale path: no vertex gathers).

    Same float op order as the triangle path (morton_code.wgsl:109-110)
    with the point itself as the centroid and `size` as the AABB diagonal
    length (0 when None).
    """
    c = jnp.stack([x, y, z], axis=-1)
    prod = _rounded((c - params.offset) * params.multiplier)
    val = prod - jnp.float32(0.001)
    q = jnp.clip(val, 0.0, float(_COORD_MAX)).astype(jnp.uint32)
    if size is None:
        j = jnp.zeros(x.shape[0], dtype=jnp.uint32)
    else:
        j = jnp.clip(size * params.size_multiplier, 0.0,
                     float(_SIZE_INDEX_MAX)).astype(jnp.uint32)
    return q, j


def encode_points(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray,
                  params: MortonParams,
                  size: jnp.ndarray | None = None) -> U64:
    """Extended-morton keys for columnar point data (f32 columns).

    The query-engine-scale entry point: rows are (x, y, z[, size]) columns
    of a Table; no triangle index gathers. Uses the direct bit-interleave.
    """
    q, j = quantize_points(x, y, z, size, params)
    return encode_quantized(q, j)
