"""Distributed x out-of-core exact quantiles: the full composition cell.

ops/bigquantile.py selects order statistics over ONE chip's sorted runs
without paying the merge; exchange/dquantile.py selects over a mesh
without moving rows. The two compose with nothing new: every device
holds ITS shard of the runs, each greedy bit round's global count is
the psum of the per-device per-run searchsorted sums, and the greedy
state stays replicated — so data larger than one device's HBM answers
exact PERCENTILE_DISC with

  interconnect = 64 rounds x one (Q,) psum   (no row ever moves)

against dbigsort's full segment exchange of 12-16 B/row. The exact rank
certificate (count_lt <= r < count_le — rank correctness AND element
membership) verifies on device exactly as in the single-chip driver.

Data model: the same regenerable keygen_hash(global index) stream as
sort/bigsort.py — device d generates runs over its contiguous index
range, so the union across the mesh is bit-identical to the single-chip
data at the same n (tests assert answers match quantile_big's and the
regenerated-key numpy oracle).

Reference contrast: the reference is one device, one queue submit
(/root/reference/src/main.rs:727); SURVEY §2c mandates the scaled
composition, applied here to the selection family.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tpu_qe.bits import U64
from tpu_qe.exchange.shuffle import AXIS
from tpu_qe.hashing import keygen_hash
from tpu_qe.ops.join import searchsorted_u64
from tpu_qe.ops.quantile import canon_qs, disc_rank


@functools.partial(jax.jit, static_argnames=("mesh", "runs_per_dev",
                                             "run_size", "seed",
                                             "key_bits"))
def _make_runs_dist(rr: jnp.ndarray, mesh: Mesh, runs_per_dev: int,
                    run_size: int, seed: int, key_bits: int):
    """Phase A program: run rr of EVERY device (device d's global run id
    is d*runs_per_dev + rr), sorted locally, sharded over the mesh."""

    def body(rr_rep):
        my = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        gr = my * jnp.uint32(runs_per_dev) + rr_rep[0]
        idx = (gr * jnp.uint32(run_size)
               + jnp.arange(run_size, dtype=jnp.uint32))
        k = keygen_hash(idx, seed)
        lo, hi = k.lo, k.hi
        if key_bits <= 32:
            if key_bits < 32:
                lo = lo & jnp.uint32((1 << key_bits) - 1)
            hi = jnp.zeros_like(hi)
        elif key_bits < 64:
            hi = hi & jnp.uint32((1 << (key_bits - 32)) - 1)
        shi, slo = jax.lax.sort([hi, lo], num_keys=2, is_stable=False)
        return slo, shi

    fn = shard_map(body, mesh=mesh, in_specs=(P(None),),
                   out_specs=(P(AXIS), P(AXIS)), check_vma=False)
    return fn(jnp.full((1,), rr, dtype=jnp.uint32))


def _select_shard(*planes, ranks: tuple):
    """Per-shard selection: greedy 64 bit rounds where each count is the
    psum of this shard's per-run searchsorted sums."""
    n_runs = len(planes) // 2
    runs_lo, runs_hi = planes[:n_runs], planes[n_runs:]
    q = len(ranks)
    r = jnp.asarray(ranks, dtype=jnp.uint32)

    def count(c_lo, c_hi, side):
        tot = jnp.zeros(q, dtype=jnp.uint32)
        for lo, hi in zip(runs_lo, runs_hi):
            s = searchsorted_u64(U64(lo, hi), U64(c_lo, c_hi), side=side)
            tot = tot + s.astype(jnp.uint32)
        return jax.lax.psum(tot, AXIS)

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
    return (p_lo.reshape(1, -1), p_hi.reshape(1, -1),
            cert.reshape(1))


@functools.partial(jax.jit, static_argnames=("mesh", "ranks"))
def _select_dist(planes: tuple, mesh: Mesh, ranks: tuple):
    spec = P(AXIS)
    fn = shard_map(
        functools.partial(_select_shard, ranks=ranks),
        mesh=mesh, in_specs=tuple([spec] * len(planes)),
        out_specs=(P(AXIS, None), P(AXIS, None), P(AXIS)),
        check_vma=False)
    return fn(*planes)


@dataclasses.dataclass
class DistBigQuantileResult:
    n: int
    values: np.ndarray
    ranks: tuple
    cert_ok: bool
    seconds: float
    runs_s: float
    select_s: float
    rows_per_s: float
    n_runs: int           # global run count (devices x runs/dev)
    n_dev: int

    @property
    def all_ok(self) -> bool:
        return bool(self.cert_ok)


def quantile_big_distributed(n: int, qs, mesh: Mesh,
                             run_size: int = 1 << 26, seed: int = 7,
                             key_bits: int = 64, verbose: bool = False,
                             ranks: tuple | None = None
                             ) -> DistBigQuantileResult:
    """Exact global PERCENTILE_DISC over n keys sharded as out-of-core
    sorted runs across the mesh (see module docstring). `ranks`
    overrides the DISC rank derivation (CONT driver below)."""
    n_dev = int(mesh.shape[AXIS])
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    runs_per_dev = n // (n_dev * run_size)
    if ranks is None:
        spec = canon_qs(qs)
        ranks = tuple(disc_rank(num, sh, n) for num, sh in spec)

    # AOT-compile outside the timed region (same discipline as
    # ops/bigquantile.py)
    mk = _make_runs_dist.lower(
        jnp.uint32(0), mesh=mesh, runs_per_dev=runs_per_dev,
        run_size=run_size, seed=seed, key_bits=key_bits).compile()
    ex = tuple(jax.ShapeDtypeStruct((n_dev * run_size,), jnp.uint32)
               for _ in range(2 * runs_per_dev))
    sel = _select_dist.lower(ex, mesh=mesh, ranks=ranks).compile()

    t0 = time.perf_counter()
    runs_lo, runs_hi = [], []
    for rr in range(runs_per_dev):
        lo, hi = mk(jnp.uint32(rr))
        runs_lo.append(lo)
        runs_hi.append(hi)
    for lo in runs_lo:
        np.asarray(jax.device_get(lo[:1]))  # fence phase A
    t1 = time.perf_counter()
    p_lo, p_hi, cert = sel(tuple(runs_lo) + tuple(runs_hi))
    values = (np.asarray(p_lo)[0].astype(np.uint64)
              | (np.asarray(p_hi)[0].astype(np.uint64) << np.uint64(32)))
    cert_ok = bool(np.asarray(cert).all())
    t2 = time.perf_counter()
    if verbose:
        print(f"dbigquantile: {n_dev} dev x {runs_per_dev} runs "
              f"{t1 - t0:.2f}s, select {t2 - t1:.2f}s, "
              f"cert={'OK' if cert_ok else 'FAIL'}")
    secs = t2 - t0
    return DistBigQuantileResult(
        n=n, values=values, ranks=ranks, cert_ok=cert_ok, seconds=secs,
        runs_s=t1 - t0, select_s=t2 - t1, rows_per_s=n / secs,
        n_runs=n_dev * runs_per_dev, n_dev=n_dev)


def quantile_cont_big_distributed(n: int, qs, mesh: Mesh,
                                  run_size: int = 1 << 26, seed: int = 7,
                                  key_bits: int = 64,
                                  verbose: bool = False):
    """Exact global PERCENTILE_CONT over mesh-sharded out-of-core runs:
    floor/ceil rank pairs ride the same psum'd bitwise selection (2Q
    ranks, each rank-certified); exact fractional numerators are host
    integers. Returns ops/bigquantile.BigContQuantileResult."""
    from tpu_qe.ops.bigquantile import BigContQuantileResult
    from tpu_qe.ops.quantile import cont_rank

    spec = canon_qs(qs)
    trip = [cont_rank(num, sh, n) for num, sh in spec]
    ranks = tuple(r for f, c, _ in trip for r in (f, c))
    res = quantile_big_distributed(n, None, mesh, run_size=run_size,
                                   seed=seed, key_bits=key_bits,
                                   verbose=verbose, ranks=ranks)
    return BigContQuantileResult(
        n=n, lower=res.values[0::2], upper=res.values[1::2],
        frac_num=tuple(fr for _, _, fr in trip),
        shifts=tuple(sh for _, sh in spec), cert_ok=res.cert_ok,
        seconds=res.seconds, rows_per_s=res.rows_per_s,
        n_runs=res.n_runs)
