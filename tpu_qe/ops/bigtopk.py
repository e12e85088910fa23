"""Out-of-core top-k: select k extreme rows from more rows than one sort.

Selection composes perfectly over runs (top-k of per-run top-ks is the
global top-k — every global winner is a winner of its own run), so the
out-of-core shape is the cheapest of the family:

  phase A   per run: generate on device (regenerable index hash, see
            sort/bigsort.py) and keep only the run's k best (key,
            payload) rows — R * k * 12 B survives phase A, independent
            of n.
  phase B   one tiny program: sort the R*k candidates, take k, verify on
            device — winners key-sorted, every key == hash(payload)
            (regenerable-row check), payloads distinct (permutation
            evidence via a payload-keyed sort).

Ties break by payload (= global row index) ascending — bit-identical to
a global STABLE sort + head, asserted against numpy at test scale.

Like the in-core `ops/topk.py` (sort + head), phase A is one 3-operand
sort per run — the selection
variant of bigsort's phase A with the merge replaced by a k-slice.

Reference contrast: the reference sorts 3,000 keys in one dispatch chain
(/root/reference/src/main.rs:594-665); this selects from data that
cannot even be resident, with the same verified-on-device discipline.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.hashing import keygen_hash

_ONES = jnp.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("run_size", "k", "seed",
                                             "largest"))
def _run_topk(r: jnp.ndarray, run_size: int, k: int, seed: int,
              largest: bool):
    """Phase A: run r's k best rows (key-ordered, ties by payload)."""
    idx = r * jnp.uint32(run_size) + jnp.arange(run_size, dtype=jnp.uint32)
    key = keygen_hash(idx, seed)
    lo, hi = key.lo, key.hi
    if largest:
        lo, hi = ~lo, ~hi        # complement: largest-first == smallest
    shi, slo, spay = jax.lax.sort([hi, lo, idx], num_keys=3,
                                  is_stable=False)
    return slo[:k], shi[:k], spay[:k]


def _sorted_head(lo, hi, pay, k: int):
    """Best-k rows of a candidate set (planes pre-complemented when the
    caller wants largest-first) — ties break by payload ascending."""
    shi, slo, spay = jax.lax.sort([hi, lo, pay], num_keys=3,
                                  is_stable=False)
    return slo[:k], shi[:k], spay[:k]


def _verify_winners(wlo_c, whi_c, wpay, k: int, seed: int, largest: bool):
    """On-device winner verification shared by the single-chip and the
    distributed combines: claimed order, key==hash(payload) row realness,
    payload distinctness (selection can never pick a row twice)."""
    # order check on the planes the sort actually ordered (complemented
    # when largest): best-first == ascending here in both modes
    ge = ((whi_c[1:] > whi_c[:-1])
          | ((whi_c[1:] == whi_c[:-1]) & (wlo_c[1:] >= wlo_c[:-1])))
    order_ok = jnp.all(ge)
    wlo, whi = (~wlo_c, ~whi_c) if largest else (wlo_c, whi_c)
    want = keygen_hash(wpay, seed)
    hash_ok = jnp.all((wlo == want.lo) & (whi == want.hi))
    p_sorted = jnp.sort(wpay)
    distinct_ok = jnp.all(p_sorted[1:] > p_sorted[:-1]) if k > 1 \
        else jnp.bool_(True)
    return (wlo, whi, wpay, hash_ok.astype(jnp.uint32),
            order_ok.astype(jnp.uint32), distinct_ok.astype(jnp.uint32))


@functools.partial(jax.jit, static_argnames=("k", "seed", "largest"))
def _combine_topk(parts, k: int, seed: int, largest: bool):
    """Phase B: global k from the R*k candidates + device verification."""
    lo = jnp.concatenate([p[0] for p in parts])
    hi = jnp.concatenate([p[1] for p in parts])
    pay = jnp.concatenate([p[2] for p in parts])
    wlo_c, whi_c, wpay = _sorted_head(lo, hi, pay, k)
    return _verify_winners(wlo_c, whi_c, wpay, k, seed, largest)


@dataclasses.dataclass(frozen=True)
class BigTopKResult:
    n: int
    k: int
    seconds: float
    rows_per_s: float
    hash_ok: bool              # every winner is a real generated row
    order_ok: bool             # winners in claimed key order
    distinct_ok: bool          # no row selected twice
    phase_a_s: float
    phase_b_s: float
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return self.hash_ok and self.order_ok and self.distinct_ok


def top_k_big(n: int, k: int, run_size: int = 1 << 26, seed: int = 7,
              largest: bool = False, verbose: bool = False,
              collect: bool = False):
    """Out-of-core top-k of n device-generated rows.

    Returns BigTopKResult; collect=True additionally returns the winner
    (keys u64, payloads u32) numpy arrays best-first (for oracle tests).
    """
    assert n % run_size == 0, (n, run_size)
    assert n < (1 << 32), "payload travels as u32 global index"
    assert 0 < k <= run_size, (k, run_size)
    n_runs = n // run_size
    assert n_runs * k < (1 << 28), \
        ("candidate set exceeds the in-core combine; recurse the "
         "combine (top-k of candidate top-ks) for k this large",
         n_runs, k)

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    run_exec = _run_topk.lower(jnp.uint32(0), run_size=run_size, k=k,
                               seed=seed, largest=largest).compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    parts = [run_exec(jnp.uint32(r)) for r in range(n_runs)]
    np.asarray(parts[-1][0][-1:])  # fence after queueing ALL dispatches
    t_a = time.perf_counter() - t0

    tcb = time.perf_counter()
    comb_exec = _combine_topk.lower(tuple(parts), k=k, seed=seed,
                                    largest=largest).compile()
    compile_s += time.perf_counter() - tcb

    t1 = time.perf_counter()
    out = comb_exec(tuple(parts))
    h_ok, o_ok, d_ok = (int(np.asarray(x)) for x in out[3:])
    t_b = time.perf_counter() - t1
    dt = t_a + t_b
    res = BigTopKResult(
        n=n, k=k, seconds=dt, rows_per_s=n / dt, hash_ok=bool(h_ok),
        order_ok=bool(o_ok), distinct_ok=bool(d_ok),
        phase_a_s=t_a, phase_b_s=t_b, compile_s=compile_s)
    if verbose:
        print(f"bigtopk: n={n} k={k} R={n_runs} largest={largest} "
              f"A={t_a:.2f}s B={t_b:.2f}s ok={res.all_ok}")
    if collect:
        wlo, whi, wpay = (np.asarray(x) for x in out[:3])
        keys = (whi.astype(np.uint64) << np.uint64(32)) \
            | wlo.astype(np.uint64)
        return res, (keys, wpay)
    return res
