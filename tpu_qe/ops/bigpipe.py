"""Out-of-core fused pipeline: join -> GROUP BY with no join materialization.

The join output of a 512M x 512M FK join is itself out-of-core; writing
it anywhere (HBM or host) just to re-read it for aggregation would double
the bottleneck traffic. This module chains the two out-of-core engines so
the join output never exists:

  ops/bigjoin.py streams each bucket's joined rows as DEVICE arrays
  (`consume` contract, global key order) -> each bucket is PARTIALLY
  aggregated on device the moment it is produced (group = hash of the
  join key mod G, value = the joined right value; only matched rows
  count) -> only the G-bounded partial group table survives each bucket
  -> one bigagg combine (ops/bigagg.py::_combine) merges the B partial
  tables with exact u64 pair sums.

This is the out-of-core generalization of the in-core fused pipeline
(`join_fk_scan(output="stream") + group_aggregate_sorted`, round 3) and
the same "aggregation IS compression" argument as ops/bigagg.py: HBM
traffic ~ the join's own traffic + B * partial_cap * 20 B of tables.

Verification: the exact-count closed form survives the composition —
matched rows are exactly the even left indices (bigjoin's construction),
so the combined group-count total must equal (n_l+1)//2, checked on
device alongside key uniqueness; per-group sums are numpy-oracle-checked
at test scale (the joined values are key hashes — no closed-form total).

Reference contrast: the reference's 41-dispatch pipeline keeps every
intermediate in GPU buffers (/root/reference/src/main.rs:376-688); here
the intermediate (the join stream) is consumed at production and never
stored — the composition the single-dispatch-chain model cannot express.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.bits import U64
from tpu_qe.ops.aggregate import group_aggregate
from tpu_qe.ops.bigagg import _combine, _host_table, _ONES
from tpu_qe.ops.bigjoin import join_big
from tpu_qe.hashing import murmur_fmix32 as _murmur_fmix32

_GSALT = jnp.uint32(0x7F4A7C15)


@functools.partial(jax.jit, static_argnames=("n_groups", "partial_cap"))
def _bucket_partial(klo, khi, value, matched, valid, n_groups: int,
                    partial_cap: int):
    """Aggregate one joined bucket on device: group = hash(join key) mod
    G over MATCHED rows only; emits the sentinel-padded partial table
    (the ops/bigagg.py padding discipline — sentinel keys, zero
    counts/sums — so _combine merges the buckets unchanged)."""
    g = _murmur_fmix32(klo ^ khi ^ _GSALT) % jnp.uint32(n_groups)
    mask = (matched > 0) & (valid > 0)
    res = group_aggregate(U64(g, jnp.zeros_like(g)), value,
                          aggs=("count", "sum"), valid=mask)
    ok = jnp.arange(partial_cap, dtype=jnp.uint32) < res.num_groups

    def cut(a, fill):
        return jnp.where(ok, jax.lax.slice(a, (0,), (partial_cap,)), fill)

    s = res.aggs["sum"]
    return (cut(res.key.lo, _ONES), cut(res.key.hi, _ONES),
            cut(res.aggs["count"], jnp.uint32(0)),
            cut(s.lo, jnp.uint32(0)), cut(s.hi, jnp.uint32(0)))


def group_of_join_key_numpy(key_u64: np.ndarray, n_groups: int
                            ) -> np.ndarray:
    """Numpy mirror of the bucket group hash (for oracle tests)."""
    from tpu_qe.hashing import murmur_fmix32_numpy
    h = ((key_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
         ^ (key_u64 >> np.uint64(32)).astype(np.uint32)
         ^ np.uint32(0x7F4A7C15))
    return (murmur_fmix32_numpy(h).astype(np.uint64)
            % np.uint64(n_groups)).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class BigPipeResult:
    n_l: int
    n_r: int
    matched: int
    n_groups: int
    seconds: float
    rows_per_s: float
    join_ok: bool              # every bigjoin on-device check
    count_ok: bool             # group-count total == exact match count
    keys_ok: bool              # group keys strictly ascending (unique)
    compile_s: float = 0.0

    @property
    def all_ok(self) -> bool:
        return self.join_ok and self.count_ok and self.keys_ok


def join_aggregate_big(n_l: int, n_r: int, n_groups: int = 1 << 16,
                       n_buckets: int | None = None, seed: int = 7,
                       verbose: bool = False, collect: bool = False):
    """Fused out-of-core FK join -> GROUP BY of the joined values.

    Runs join_big with a consume hook that partially aggregates each
    bucket on device as it is produced, then combines the B partial
    tables (exact u64 sums). collect=True returns the assembled host
    group table dict(key, count, sum) (oracle tests only).
    """
    partials = []
    # the bucket shape (cap_l) is decided inside join_big's planning, so
    # the partial-aggregate executable AOT-compiles lazily at the FIRST
    # consume call — its compile time is tracked and excluded from the
    # reported wall time, like every other compile in the big drivers
    state = {"exec": None, "compile_s": 0.0}

    def consume(b, bucket):
        # a bucket cannot hold more distinct groups than rows: cap the
        # partial table at the bucket's static row capacity
        if state["exec"] is None:
            pc = min(n_groups, int(bucket["value"].shape[0]))
            tc = time.perf_counter()
            state["exec"] = _bucket_partial.lower(
                bucket["key"].lo, bucket["key"].hi, bucket["value"],
                bucket["matched"], bucket["valid"], n_groups=n_groups,
                partial_cap=pc).compile()
            state["compile_s"] = time.perf_counter() - tc
        partials.append(state["exec"](
            bucket["key"].lo, bucket["key"].hi, bucket["value"],
            bucket["matched"], bucket["valid"]))

    jres = join_big(n_l, n_r, n_buckets=n_buckets, seed=seed,
                    verbose=verbose, consume=consume)

    tcb = time.perf_counter()
    comb_exec = _combine.lower(tuple(partials), collect=collect,
                               minmax=False).compile()
    combine_compile_s = time.perf_counter() - tcb
    t1 = time.perf_counter()
    out = comb_exec(tuple(partials))
    scal = [int(np.asarray(x)) for x in out[:6]]
    ng, total_cnt, _, _, ks, _ = scal
    t_combine = time.perf_counter() - t1
    # the first-bucket compile happened INSIDE join_big's timed bucket
    # phase — subtract it from the composed wall time
    dt = jres.seconds + t_combine - state["compile_s"]
    res = BigPipeResult(
        n_l=n_l, n_r=n_r, matched=jres.matched, n_groups=ng,
        seconds=dt, rows_per_s=n_l / dt, join_ok=jres.all_ok,
        count_ok=(total_cnt == jres.matched == (n_l + 1) // 2),
        keys_ok=bool(ks),
        compile_s=jres.compile_s + state["compile_s"] + combine_compile_s)
    if verbose:
        print(f"bigpipe: {n_l}x{n_r} -> {jres.matched} matches -> "
              f"{ng} groups in {dt:.2f}s ok={res.all_ok}")
    if collect:
        return res, _host_table(out[6:], minmax=False)
    return res
