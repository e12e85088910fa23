"""Out-of-core set operations: UNION / INTERSECT / EXCEPT past HBM.

The in-core operator (ops/setops.py) answers DISTINCT-semantics set
algebra in one (key, side) sort. Out of core, dedup IS the compression
(the invariant of ops/bigdistinct.py, applied to set algebra): only
each run's DISTINCT keys + their exact multiplicities carry
information, so

  phase A   per run, per side: generate keys on device (regenerable
            index functions; no host streaming), sort, compact distinct keys + exact occurrence
            counts to a padded prefix. Partial-capacity overflow is
            DETECTED exactly (count readback), never truncated.
  phase B   one resident program over all partial tables (both sides,
            a side plane riding along): key sort, per-key side
            multiplicities from two cumsum differences (cross-run
            duplicate keys collapse — their occurrence counts sum in
            the cumsums, the same algebra as distributed_set_op), the
            op predicate, and a compaction of qualifying keys WITH
            per-side multiplicities (so ALL/bag semantics stay one
            expand_ranges away, as in-core).

Data model (closed-form verifiable at any scale): side A holds n_a
rows with key = idx mod g_a (keys [0, g_a)); side B holds n_b rows
with key = idx mod g_b + offset (keys [offset, offset + g_b)) — the
offset dials the overlap from disjoint through partial to subset.
Phase B proves on device, for EVERY distinct key: count_a and count_b
equal their closed forms, keys strictly increasing, and the host
cross-checks the qualifying-key count against the numpy closed form —
together (uniqueness + per-key counts + predicate + total) this pins
the exact result set.

Reference contrast: the reference has no query operators; this extends
the SURVEY §7 operator mandate's set-algebra family (ops/setops.py,
exchange/dops.py::distributed_set_op) to out-of-core scale.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_qe.ops.aggregate import _shift_right_one
from tpu_qe.ops.segscan import cumsum_u32
from tpu_qe.ops.setops import _OPS, _qualifies

_ONES = jnp.uint32(0xFFFFFFFF)


def keys_of_index(idx: jnp.ndarray, n_groups: int, offset: int):
    """Side key for global row idx — device + numpy-mirrorable."""
    return idx % jnp.uint32(n_groups) + jnp.uint32(offset)


def side_counts_numpy(keys: np.ndarray, n_rows: int, n_groups: int,
                      offset: int) -> np.ndarray:
    """Closed-form multiplicity of each key in a side's bag."""
    k = keys.astype(np.int64) - offset
    inside = (k >= 0) & (k < n_groups)
    extra = k < (n_rows % n_groups)
    return np.where(inside,
                    n_rows // n_groups + extra.astype(np.int64),
                    0).astype(np.uint32)


def expected_result_numpy(op: str, n_a: int, g_a: int, n_b: int,
                          g_b: int, offset: int):
    """The full expected (keys, count_a, count_b) by closed form."""
    dom = np.arange(max(g_a, offset + g_b), dtype=np.uint32)
    ca = side_counts_numpy(dom, n_a, g_a, 0)
    cb = side_counts_numpy(dom, n_b, g_b, offset)
    keep = np.asarray(_qualifies(op, ca > 0, cb > 0))
    return dom[keep], ca[keep], cb[keep]


@functools.partial(jax.jit, static_argnames=("run_size", "n_groups",
                                             "offset", "partial_cap"))
def _dedup_run(r: jnp.ndarray, run_size: int, n_groups: int, offset: int,
               partial_cap: int):
    """Phase A: one side-run's distinct (key, occurrences) padded table
    + the exact distinct-key count (overflow detection)."""
    idx = r * jnp.uint32(run_size) + jnp.arange(run_size, dtype=jnp.uint32)
    k = keys_of_index(idx, n_groups, offset)
    sk = jax.lax.sort([k], num_keys=1, is_stable=False)[0]
    pos = jnp.arange(run_size, dtype=jnp.uint32)
    key_new = (pos == 0) | (sk != _shift_right_one(sk, 0))
    m = jnp.sum(key_new.astype(jnp.uint32), dtype=jnp.uint32)
    key_end = jnp.concatenate([key_new[1:], jnp.ones((1,), bool)])
    pos1 = pos + 1
    packed = jnp.where(key_end, pos1, pos1 | jnp.uint32(1 << 31))
    res = jax.lax.sort([packed, sk], num_keys=1, is_stable=False)
    pe = res[0] & jnp.uint32(0x7FFFFFFF)
    occ = pe - _shift_right_one(pe, 0)
    valid = jnp.arange(partial_cap, dtype=jnp.uint32) < m

    def cut(a, fill):
        return jnp.where(valid, jax.lax.slice(a, (0,), (partial_cap,)),
                         fill)

    return cut(res[1], _ONES), cut(occ, jnp.uint32(0)), m


@functools.partial(jax.jit, static_argnames=(
    "op", "n_a", "g_a", "n_b", "g_b", "offset", "collect"))
def _combine(klo, side, occ, op: str, n_a: int, g_a: int, n_b: int,
             g_b: int, offset: int, collect: bool):
    """Phase B: merge all partial tables, qualify, verify closed form.

    Sentinel rows (key all-ones, occ 0) sort to the tail; occurrence
    counts of duplicate keys (across runs AND across sides) sum inside
    the two cumsums, so no pre-dedup pass is needed."""
    m = klo.shape[0]
    sk, ss, so = jax.lax.sort([klo, side, occ], num_keys=1,
                              is_stable=False)
    pos = jnp.arange(m, dtype=jnp.uint32)
    sent = sk == _ONES
    key_new = ((pos == 0) | (sk != _shift_right_one(sk, 0))) & ~sent
    key_end = ~sent & jnp.concatenate(
        [(key_new | sent)[1:], jnp.ones((1,), bool)])
    n_keys = jnp.sum(key_end.astype(jnp.uint32), dtype=jnp.uint32)
    cum_b = cumsum_u32(so * ss)          # side-B occurrences so far
    cum_tot = cumsum_u32(so)
    pos1 = pos + 1
    packed = jnp.where(key_end, pos1, pos1 | jnp.uint32(1 << 31))
    res = jax.lax.sort([packed, sk, cum_b, cum_tot], num_keys=1,
                       is_stable=False)
    gkey = res[1]
    cb = res[2] - _shift_right_one(res[2], 0)
    ca = (res[3] - _shift_right_one(res[3], 0)) - cb
    gvalid = pos < n_keys
    # closed-form per-key certificate (data model in module docstring)
    want_ca = jnp.where(gkey < jnp.uint32(g_a),
                        jnp.uint32(n_a // g_a)
                        + (gkey < jnp.uint32(n_a % g_a)).astype(jnp.uint32),
                        jnp.uint32(0))
    kb = gkey - jnp.uint32(offset)
    in_b = (gkey >= jnp.uint32(offset)) & (kb < jnp.uint32(g_b))
    want_cb = jnp.where(in_b,
                        jnp.uint32(n_b // g_b)
                        + (kb < jnp.uint32(n_b % g_b)).astype(jnp.uint32),
                        jnp.uint32(0))
    counts_ok = jnp.all(jnp.where(gvalid, (ca == want_ca) & (cb == want_cb),
                                  True))
    keys_ok = jnp.all(jnp.where(gvalid[1:], gkey[1:] > gkey[:-1], True))
    keep = gvalid & _qualifies(op, ca > 0, cb > 0)
    num = jnp.sum(keep.astype(jnp.uint32), dtype=jnp.uint32)
    checks = (counts_ok, keys_ok, num)
    if not collect:
        return checks, ()
    packed2 = jnp.where(keep, pos, pos | jnp.uint32(1 << 31))
    res2 = jax.lax.sort([packed2, gkey, ca, cb], num_keys=1,
                        is_stable=False)
    rvalid = pos < num
    return checks, (jnp.where(rvalid, res2[1], _ONES),
                    jnp.where(rvalid, res2[2], 0),
                    jnp.where(rvalid, res2[3], 0))


@dataclasses.dataclass
class BigSetOpResult:
    op: str
    n_a: int
    n_b: int
    g_a: int
    g_b: int
    offset: int
    n_runs_a: int
    n_runs_b: int
    num: int                  # qualifying keys found on device
    expected_num: int         # numpy closed form
    counts_ok: bool
    keys_ok: bool
    overflow: bool
    seconds: float
    dedup_s: float
    combine_s: float
    rows_per_s: float
    table: dict | None = None

    @property
    def all_ok(self) -> bool:
        return (self.counts_ok and self.keys_ok and not self.overflow
                and self.num == self.expected_num)


def set_op_big(op: str, n_a: int, n_b: int, g_a: int = 1 << 20,
               g_b: int = 1 << 20, offset: int = 1 << 19,
               run_size: int = 1 << 26, partial_cap: int | None = None,
               collect: bool = False, verbose: bool = False
               ) -> BigSetOpResult:
    """DISTINCT-semantics set operation over two device-generated key
    bags larger than HBM, out-of-core (see module docstring)."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    for n, nm in ((n_a, "n_a"), (n_b, "n_b")):
        assert n % run_size == 0, (nm, n, run_size)
    assert n_a + n_b < (1 << 32)
    assert max(g_a, offset + g_b) < (1 << 32) - 1
    runs_a, runs_b = n_a // run_size, n_b // run_size
    caps = {}
    for s, g in ((0, g_a), (1, g_b)):
        cap = partial_cap if partial_cap is not None \
            else min(-(-min(run_size, g) // 128) * 128, run_size)
        caps[s] = cap
    np.asarray(jnp.zeros(8, jnp.uint32)[:1])  # device init, untimed
    mks = {
        s: _dedup_run.lower(jnp.uint32(0), run_size=run_size,
                            n_groups=g, offset=off,
                            partial_cap=caps[s]).compile()
        for s, (g, off) in {0: (g_a, 0), 1: (g_b, offset)}.items()}
    m_tot = runs_a * caps[0] + runs_b * caps[1]
    ex = jax.ShapeDtypeStruct((m_tot,), jnp.uint32)
    cb = _combine.lower(ex, ex, ex, op=op, n_a=n_a, g_a=g_a, n_b=n_b,
                        g_b=g_b, offset=offset, collect=collect).compile()

    t0 = time.perf_counter()
    parts, sides, m_counts, cap_of = [], [], [], []
    for s, runs in ((0, runs_a), (1, runs_b)):
        for rr in range(runs):
            klo, occ, mcnt = mks[s](jnp.uint32(rr))
            parts.append((klo, occ))
            sides.append(jnp.full((caps[s],), s, jnp.uint32))
            m_counts.append(mcnt)
            cap_of.append(caps[s])
    m_host = np.array([int(np.asarray(mv)) for mv in m_counts])
    overflow = bool((m_host > np.array(cap_of)).any())   # fence A
    t1 = time.perf_counter()
    klo = jnp.concatenate([p[0] for p in parts])
    side = jnp.concatenate(sides)
    occ = jnp.concatenate([p[1] for p in parts])
    checks, planes = cb(klo, side, occ)
    counts_ok, keys_ok, num = (np.asarray(c) for c in checks)
    t2 = time.perf_counter()
    ek, _, _ = expected_result_numpy(op, n_a, g_a, n_b, g_b, offset)
    table = None
    if collect:
        gk, ca_p, cb_p = (np.asarray(p) for p in planes)
        keep = gk != 0xFFFFFFFF
        table = {"key": gk[keep], "count_a": ca_p[keep],
                 "count_b": cb_p[keep]}
    if verbose:
        print(f"bigsetops[{op}]: {runs_a}+{runs_b} runs dedup "
              f"{t1 - t0:.2f}s (keys/run max {m_host.max()}), combine "
              f"{t2 - t1:.2f}s, {int(num)} keys")
    secs = t2 - t0
    return BigSetOpResult(
        op=op, n_a=n_a, n_b=n_b, g_a=g_a, g_b=g_b, offset=offset,
        n_runs_a=runs_a, n_runs_b=runs_b, num=int(num),
        expected_num=len(ek), counts_ok=bool(counts_ok),
        keys_ok=bool(keys_ok), overflow=overflow, seconds=secs,
        dedup_s=t1 - t0, combine_s=t2 - t1,
        rows_per_s=(n_a + n_b) / secs, table=table)
