"""u64 key sort drivers (single device).

The reference's 8-pass LSD radix pipeline (run_compute_shaders,
reference src/main.rs:594-665) issues 5 dispatches per pass
(histogram, 2x hierarchical scan, small scan, scatter). Here the whole sort
is one variadic ``jax.lax.sort`` over the (hi, lo) u32 word planes, which
XLA compiles for the device; the pass schedule survives only as
``key_bits`` (the reference's NUM_PASSES * BITS_PER_PASS semantics).

Backends:

- ``xla``: stable sort on the (hi, lo) word pair; any payloads.
- ``xla_tiebreak``: unstable 3-key sort with payloads[0] as the third key.
  When payloads[0] is a unique row index it returns the stable-by-key
  result bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.bits import U64, masked_key

# Default backends, by payload contract:
# - BEST_BACKEND: arbitrary payloads — XLA's stable variadic sort.
# - BEST_UNIQUE_PAYLOAD_BACKEND: when payloads[0] is a unique index (the
#   flagship (morton code, row index) shape), the unstable 3-key tiebreak
#   sort returns the bit-identical stable result. bench.py and the
#   pipeline consult this constant.
BEST_BACKEND = "xla"
BEST_UNIQUE_PAYLOAD_BACKEND = "xla_tiebreak"


def _sort_xla(lo, hi, payloads, key_bits, stable=True):
    mlo, mhi = masked_key(lo, hi, key_bits)
    if key_bits >= 64:
        operands = [hi, lo] + list(payloads)
        res = jax.lax.sort(operands, num_keys=2, is_stable=stable)
        return res[1], res[0], list(res[2:])
    operands = [mhi, mlo, lo, hi] + list(payloads)
    res = jax.lax.sort(operands, num_keys=2, is_stable=stable)
    return res[2], res[3], list(res[4:])


def _sort_xla_tiebreak(lo, hi, payloads, key_bits):
    """Stable-equivalent sort when payloads[0] is a UNIQUE index.

    An unstable 3-key sort with the unique payload as tiebreak returns
    exactly the stable-by-key result: the payload word is carried anyway,
    and the sort need not keep equal keys in order. This is the flagship
    pipeline's exact shape — the reference sorts (morton code, triangle
    index) pairs where the payload IS the unique index
    (/root/reference/src/main.rs:376-688).
    """
    mlo, mhi = masked_key(lo, hi, key_bits)
    if key_bits >= 64:
        operands = [hi, lo] + list(payloads)
        res = jax.lax.sort(operands, num_keys=3, is_stable=False)
        return res[1], res[0], list(res[2:])
    operands = [mhi, mlo, payloads[0], lo, hi] + list(payloads[1:])
    res = jax.lax.sort(operands, num_keys=3, is_stable=False)
    return res[3], res[4], [res[2]] + list(res[5:])


@functools.partial(
    jax.jit,
    static_argnames=("key_bits", "backend", "stable"))
def sort_u64(key: U64, *payloads: jnp.ndarray, key_bits: int = 64,
             backend: str = "xla", stable: bool = True):
    """Stable sort of u64 keys (as (lo, hi) u32 pairs) with u32 payloads.

    Sorts by the low `key_bits` bits of the key (the reference's
    NUM_PASSES * BITS_PER_PASS semantics). Returns (U64, payloads tuple).
    stable=False lets XLA use an unstable sort — use it when keys are
    unique or payload order among equals is free.
    """
    lo, hi = key
    n = lo.shape[0]
    if backend == "xla":
        slo, shi, spl = _sort_xla(lo, hi, payloads, key_bits, stable)
        return U64(slo, shi), tuple(spl)
    if backend == "xla_tiebreak":
        assert payloads, (
            "xla_tiebreak CONTRACT: payloads[0] must be a UNIQUE per-row "
            "value (normally the original ascending row index). With any "
            "other payload the result is (key, payload)-ordered, NOT the "
            "stable-by-key order. Use backend='xla' for general payloads.")
        import os
        if os.environ.get("TPU_QE_DEBUG_CHECKS"):
            # opt-in misuse detector (costs a reduction per call): the
            # common correct usage is payloads[0] == arange(n).
            bad = jnp.any(payloads[0] != jnp.arange(n, dtype=payloads[0].dtype))
            jax.lax.cond(
                bad,
                lambda: jax.debug.print(
                    "tpu_qe WARNING: xla_tiebreak payload[0] is not "
                    "arange(n); result is (key,payload)-ordered, not "
                    "stable-by-key"),
                lambda: None)
        slo, shi, spl = _sort_xla_tiebreak(lo, hi, payloads, key_bits)
        return U64(slo, shi), tuple(spl)
    raise ValueError(f"unknown backend {backend!r}")


def sort_u64_numpy(keys: np.ndarray, payload: np.ndarray | None = None,
                   **kw):
    """Numpy-in/numpy-out convenience wrapper (testing & benchmarking)."""
    k = U64.from_numpy(keys)
    payloads = () if payload is None else (jnp.asarray(payload),)
    sk, spl = sort_u64(k, *payloads, **kw)
    sk = sk.to_numpy()
    if payload is None:
        return sk
    return sk, np.asarray(spl[0])
