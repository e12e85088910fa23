"""Distributed out-of-core top-k: the last composition-matrix cell.

Selection composes exactly at EVERY level (the global top-k is the
top-k of per-run top-ks, which is the top-k of per-device top-ks), so
the distributed × out-of-core shape is a two-level candidate tree in
which every level is the SAME selection core (ops/bigtopk.py::
_sorted_head) and the final winners pass the same on-device checks
(_verify_winners: claimed order, key == hash(payload) row realness,
payload distinctness):

  phase A   every device simultaneously selects run r's k best rows of
            its local slice in one shard_map program (global row index
            d*n_local + r*run_size + lane — regenerable; no host
            streaming, see sort/bigsort.py). Only
            R * k * 12 B per device survives phase A.
  phase B   one shard_map program: each device reduces its R candidate
            sets to a local top-k, all_gathers the D local winner sets
            (the ONLY cross-device traffic: D * k * 12 B), and
            selects + verifies the replicated global winners. Every
            device holds the identical answer.

Why all_gather and not a key-ranged exchange: after local selection the
candidate sets are k-bounded — tiny next to the raw rows — so
replicating them costs less than any routed exchange, and the combine
needs no capacity planning (exactly the dbigagg argument, with k in
place of G). Ties break by payload (= global row index) ascending at
every level — bit-identical to a global stable sort + head, asserted
against numpy and against the single-chip top_k_big by the CPU-mesh
tests.

Reference contrast: the reference sorts 3,000 keys on one device
(/root/reference/src/main.rs:594-665); this selects from data larger
than one device's memory spread over a mesh, with the same
verified-on-device discipline. SURVEY.md §2c mandated composition.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tpu_qe.exchange.shuffle import AXIS
from tpu_qe.hashing import keygen_hash
from tpu_qe.ops.bigtopk import BigTopKResult, _sorted_head, _verify_winners


def _runner_fn(mesh: Mesh, n_local: int, run_size: int, k: int, seed: int,
               largest: bool):
    """Phase-A program: every device selects ITS run r's k best rows.

    Outputs stay complemented when largest (the bigtopk convention:
    complement once at generation, un-complement once at the very end)
    so every level of the candidate tree sorts ascending."""

    def body(r):
        d = jax.lax.axis_index(AXIS).astype(jnp.uint32)
        base = d * jnp.uint32(n_local) + r * jnp.uint32(run_size)
        idx = base + jnp.arange(run_size, dtype=jnp.uint32)
        key = keygen_hash(idx, seed)
        lo, hi = (~key.lo, ~key.hi) if largest else (key.lo, key.hi)
        return _sorted_head(lo, hi, idx, k)

    fn = shard_map(body, mesh=mesh, in_specs=(P(),),
                   out_specs=(P(AXIS),) * 3, check_vma=False)
    return jax.jit(fn)


def _combiner_fn(mesh: Mesh, n_runs: int, k: int, seed: int, largest: bool):
    """Phase-B program: local candidate reduce -> all_gather -> global
    select + verify. The local k-slice is safe by structure: a device's
    global winners are among its own R*k candidates."""

    def body(*flat):
        # flat: n_runs x 3 local (k,) planes per device
        lo, hi, pay = (
            jnp.concatenate([flat[r * 3 + c] for r in range(n_runs)])
            for c in range(3))
        llo, lhi, lpay = _sorted_head(lo, hi, pay, k)
        glo, ghi, gpay = (jax.lax.all_gather(a, AXIS).reshape(-1)
                          for a in (llo, lhi, lpay))
        wlo_c, whi_c, wpay = _sorted_head(glo, ghi, gpay, k)
        return _verify_winners(wlo_c, whi_c, wpay, k, seed, largest)

    fn = shard_map(body, mesh=mesh, in_specs=(P(AXIS),) * (n_runs * 3),
                   out_specs=(P(),) * 6, check_vma=False)
    return jax.jit(fn)


def top_k_big_distributed(n: int, k: int, mesh: Mesh,
                          run_size: int = 1 << 26, seed: int = 7,
                          largest: bool = False, verbose: bool = False,
                          collect: bool = False,
                          force_composed: bool = False):
    """Distributed out-of-core top-k of n generated rows over `mesh`.

    n must be divisible by D * run_size. Row model identical to
    top_k_big (key = hash(global index), payload = global index), so
    winners are bit-identical to the single-chip path at equal n —
    asserted by the CPU-mesh tests.

    With D == 1 the candidate tree has one leaf, so the call DELEGATES
    to single-chip top_k_big (same data model, same verification);
    force_composed=True keeps the shard_map machinery at D=1 (identity
    all_gather) for tests.

    Returns BigTopKResult; collect=True additionally returns the winner
    (keys u64, payloads u32) numpy arrays best-first.
    """
    n_dev = int(mesh.shape[AXIS])
    if n_dev == 1 and not force_composed:
        from tpu_qe.ops.bigtopk import top_k_big
        return top_k_big(n, k, run_size=run_size, seed=seed,
                         largest=largest, verbose=verbose, collect=collect)
    assert n % (n_dev * run_size) == 0, \
        (f"n must be a multiple of devices*run_size "
         f"(n={n}, devices={n_dev}, run_size={run_size})")
    assert n < (1 << 32), "payload travels as u32 global index"
    assert 0 < k <= run_size, (k, run_size)
    n_local = n // n_dev
    n_runs = n_local // run_size
    assert n_runs * k < (1 << 28) and n_dev * k < (1 << 28), \
        ("candidate set exceeds the in-core combine; recurse the "
         "candidate tree for k this large", n_runs, n_dev, k)

    tc0 = time.perf_counter()
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    run_exec = _runner_fn(mesh, n_local, run_size, k, seed, largest)
    run_exec = run_exec.lower(jnp.uint32(0)).compile()
    compile_s = time.perf_counter() - tc0

    t0 = time.perf_counter()
    parts = [run_exec(jnp.uint32(r)) for r in range(n_runs)]
    np.asarray(parts[-1][0][-1:])  # fence after queueing ALL dispatches
    t_a = time.perf_counter() - t0

    tcb = time.perf_counter()
    flat = tuple(a for p in parts for a in p)
    comb = _combiner_fn(mesh, n_runs, k, seed, largest)
    comb_exec = comb.lower(*flat).compile()
    compile_s += time.perf_counter() - tcb

    t1 = time.perf_counter()
    out = comb_exec(*flat)
    h_ok, o_ok, d_ok = (int(np.asarray(x)) for x in out[3:])
    t_b = time.perf_counter() - t1
    dt = t_a + t_b
    res = BigTopKResult(
        n=n, k=k, seconds=dt, rows_per_s=n / dt, hash_ok=bool(h_ok),
        order_ok=bool(o_ok), distinct_ok=bool(d_ok),
        phase_a_s=t_a, phase_b_s=t_b, compile_s=compile_s)
    if verbose:
        print(f"dbigtopk: n={n} k={k} D={n_dev} R={n_runs}/dev "
              f"largest={largest} A={t_a:.2f}s B={t_b:.2f}s "
              f"ok={res.all_ok}")
    if collect:
        wlo, whi, wpay = (np.asarray(x) for x in out[:3])
        keys = (whi.astype(np.uint64) << np.uint64(32)) \
            | wlo.astype(np.uint64)
        return res, (keys, wpay)
    return res
