"""Out-of-core exact quantiles: sorted runs + bitwise selection — the
merge phase of the out-of-core sort is never paid.

sort_big (sort/bigsort.py) answers "give me the whole sorted stream" in
three phases: runs, plan, bucket merges. PERCENTILE_DISC needs only Q
ELEMENTS of that stream, and selection over sorted runs does not need
the merge at all: the (r+1)-th smallest key is the largest v with
count_lt(v) <= r (monotone in v), count_lt(v) is the SUM of one binary
search per resident run, and the monotone predicate is solved by 64
greedy bit rounds — O(64 * R * log run_size) scalar work against the
merge phase's full O(n log n) re-sort. Same phase-A run production as
bigsort (device-generated regenerable keys, nothing crosses the host
link); phase S is ONE jitted program returning Q values + an exact
on-device rank certificate:

    count_lt(v_q) <= r_q < count_le(v_q)   for every q

which simultaneously proves rank correctness AND that v_q is an element
of the data (count_le > count_lt), with ranks derived host-side in
exact integer arithmetic (ops/quantile.disc_rank).

Reference contrast: the reference's single queue submit sorts 3,000 keys
end to end (/root/reference/src/constants.rs:3); this answers order
statistics over 1B keys without materializing the order.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.bits import U64
from tpu_qe.hashing import keygen_hash
from tpu_qe.ops.join import searchsorted_u64
from tpu_qe.ops.quantile import canon_qs, cont_rank, disc_rank


@functools.partial(jax.jit, static_argnames=("n_run", "seed", "key_bits"))
def _make_sorted_run_keys(r: jnp.ndarray, n_run: int, seed: int,
                          key_bits: int):
    """Device-generated sorted key run (keys only — selection carries no
    payload). key_bits < 64 masks keys down to force duplicate-heavy
    distributions (tests); 64 = the bigsort data model."""
    idx = r * jnp.uint32(n_run) + jnp.arange(n_run, dtype=jnp.uint32)
    k = keygen_hash(idx, seed)
    lo, hi = k.lo, k.hi
    if key_bits <= 32:
        lo = lo & jnp.uint32((1 << key_bits) - 1) if key_bits < 32 else lo
        hi = jnp.zeros_like(hi)
    elif key_bits < 64:
        hi = hi & jnp.uint32((1 << (key_bits - 32)) - 1)
    shi, slo = jax.lax.sort([hi, lo], num_keys=2, is_stable=False)
    return slo, shi


@functools.partial(jax.jit, static_argnames=("ranks",))
def _select_from_runs(runs_lo: tuple, runs_hi: tuple, ranks: tuple):
    """64 greedy bit rounds over the resident sorted runs; returns the Q
    selected values plus the exact rank certificate scalars."""
    q = len(ranks)
    r = jnp.asarray(ranks, dtype=jnp.uint32)

    def count(c_lo, c_hi, side):
        tot = jnp.zeros(q, dtype=jnp.uint32)
        for lo, hi in zip(runs_lo, runs_hi):
            s = searchsorted_u64(U64(lo, hi), U64(c_lo, c_hi), side=side)
            tot = tot + s.astype(jnp.uint32)
        return tot

    def bit_round(i, carry):
        p_lo, p_hi = carry
        b = jnp.uint32(63) - i.astype(jnp.uint32)
        sh_hi = jnp.where(b >= 32, b - 32, jnp.uint32(0))
        sh_lo = jnp.where(b < 32, b, jnp.uint32(0))
        c_hi = p_hi | jnp.where(b >= 32, jnp.uint32(1) << sh_hi,
                                jnp.uint32(0))
        c_lo = p_lo | jnp.where(b < 32, jnp.uint32(1) << sh_lo,
                                jnp.uint32(0))
        take = count(c_lo, c_hi, "left") <= r
        return (jnp.where(take, c_lo, p_lo), jnp.where(take, c_hi, p_hi))

    zero = jnp.zeros(q, dtype=jnp.uint32)
    p_lo, p_hi = jax.lax.fori_loop(0, 64, bit_round, (zero, zero))
    cnt_lt = count(p_lo, p_hi, "left")
    cnt_le = count(p_lo, p_hi, "right")
    cert = jnp.all((cnt_lt <= r) & (r < cnt_le))
    return p_lo, p_hi, cert, cnt_lt, cnt_le


@dataclasses.dataclass
class BigQuantileResult:
    n: int
    values: np.ndarray        # (Q,) u64 — exact PERCENTILE_DISC elements
    ranks: tuple              # 0-based target ranks
    cert_ok: bool             # on-device rank certificate
    seconds: float            # runs + selection (compile excluded)
    runs_s: float
    select_s: float
    rows_per_s: float
    n_runs: int

    @property
    def all_ok(self) -> bool:
        return bool(self.cert_ok)


def quantile_big(n: int, qs, run_size: int = 1 << 26, seed: int = 7,
                 key_bits: int = 64, verbose: bool = False,
                 ranks: tuple | None = None) -> BigQuantileResult:
    """Exact global PERCENTILE_DISC over n device-generated keys too big
    for one in-core sort. See the module docstring for the design.

    ranks: explicit 0-based order-statistic ranks overriding the
    PERCENTILE_DISC rank derivation (the CONT driver below selects
    floor/ceil rank pairs through the same machinery)."""
    assert n % run_size == 0, (n, run_size)
    n_runs = n // run_size
    if ranks is None:
        spec = canon_qs(qs)
        ranks = tuple(disc_rank(num, sh, n) for num, sh in spec)

    # AOT-compile outside the timed region (same discipline as
    # sort/bigsort.py); device init, untimed
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])
    mk = _make_sorted_run_keys.lower(
        jnp.uint32(0), n_run=run_size, seed=seed,
        key_bits=key_bits).compile()
    ex_lo = tuple(jax.ShapeDtypeStruct((run_size,), jnp.uint32)
                  for _ in range(n_runs))
    sel = _select_from_runs.lower(ex_lo, ex_lo, ranks=ranks).compile()

    t0 = time.perf_counter()
    runs_lo, runs_hi = [], []
    for rr in range(n_runs):
        lo, hi = mk(jnp.uint32(rr))
        runs_lo.append(lo)
        runs_hi.append(hi)
    jax.block_until_ready(runs_lo)
    t1 = time.perf_counter()
    p_lo, p_hi, cert, cnt_lt, cnt_le = sel(tuple(runs_lo), tuple(runs_hi))
    values = (np.asarray(p_lo).astype(np.uint64)
              | (np.asarray(p_hi).astype(np.uint64) << np.uint64(32)))
    cert_ok = bool(np.asarray(cert))
    t2 = time.perf_counter()
    if verbose:
        print(f"bigquantile: {n_runs} runs {t1 - t0:.2f}s, "
              f"select {t2 - t1:.2f}s, cert={'OK' if cert_ok else 'FAIL'} "
              f"lt={np.asarray(cnt_lt)} le={np.asarray(cnt_le)}")
    secs = t2 - t0
    return BigQuantileResult(
        n=n, values=values, ranks=ranks, cert_ok=cert_ok, seconds=secs,
        runs_s=t1 - t0, select_s=t2 - t1, rows_per_s=n / secs,
        n_runs=n_runs)


@dataclasses.dataclass
class BigContQuantileResult:
    """Exact rational PERCENTILE_CONT over out-of-core keys: the SQL
    answer per q is lower + (upper - lower) * frac_num/2^shift (u64
    keys — the exact fields ARE the result; see ops/quantile.py)."""
    n: int
    lower: np.ndarray         # (Q,) u64
    upper: np.ndarray
    frac_num: tuple
    shifts: tuple
    cert_ok: bool
    seconds: float
    rows_per_s: float
    n_runs: int

    @property
    def all_ok(self) -> bool:
        return bool(self.cert_ok)


def quantile_cont_big(n: int, qs, run_size: int = 1 << 26, seed: int = 7,
                      key_bits: int = 64, verbose: bool = False
                      ) -> BigContQuantileResult:
    """Exact global PERCENTILE_CONT over n device-generated keys: the
    floor/ceil rank elements of every q ride the SAME sorted-runs
    bitwise selection (2Q ranks), each with its own exact rank
    certificate; the fractional numerators are exact host integers."""
    spec = canon_qs(qs)
    trip = [cont_rank(num, sh, n) for num, sh in spec]
    ranks = tuple(r for f, c, _ in trip for r in (f, c))
    res = quantile_big(n, None, run_size=run_size, seed=seed,
                       key_bits=key_bits, verbose=verbose, ranks=ranks)
    return BigContQuantileResult(
        n=n, lower=res.values[0::2], upper=res.values[1::2],
        frac_num=tuple(fr for _, _, fr in trip),
        shifts=tuple(sh for _, sh in spec), cert_ok=res.cert_ok,
        seconds=res.seconds, rows_per_s=res.rows_per_s,
        n_runs=res.n_runs)
