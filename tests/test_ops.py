"""Query operator tests: filter/compact, group aggregate, joins."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_qe.bits import U64
from tpu_qe.ops import compact, group_aggregate, join_fk, join_sorted
from tpu_qe.ops.join import searchsorted_u64
from tpu_qe.table import Table


def _u64(rng, n, hi=1 << 64):
    return rng.integers(0, hi, size=n, dtype=np.uint64)


def _agg_np(x):
    """Aggregate column to numpy: U64 pair sums -> uint64, else asarray."""
    return x.to_numpy() if isinstance(x, U64) else np.asarray(x)


class TestTable:
    def test_roundtrip_and_pytree(self):
        import jax
        rng = np.random.default_rng(0)
        t = Table.from_numpy({
            "k": _u64(rng, 100),
            "v": rng.random(100).astype(np.float32),
            "i": np.arange(100, dtype=np.uint32),
        })
        assert t.num_rows == 100
        back = t.to_numpy()
        assert back["k"].dtype == np.uint64
        leaves = jax.tree_util.tree_leaves(t)
        assert len(leaves) == 4  # u64 -> 2 leaves
        t2 = jax.jit(lambda x: x)(t)
        np.testing.assert_array_equal(t2.to_numpy()["k"], back["k"])

    def test_take(self):
        rng = np.random.default_rng(1)
        t = Table.from_numpy({"k": _u64(rng, 50),
                              "v": np.arange(50, dtype=np.uint32)})
        idx = jnp.asarray([5, 3, 3, 49])
        sub = t.take(idx)
        np.testing.assert_array_equal(sub.to_numpy()["v"], [5, 3, 3, 49])

    def test_ragged_rejected(self):
        with pytest.raises(ValueError, match="ragged"):
            Table({"a": jnp.zeros(3, jnp.uint32), "b": jnp.zeros(4, jnp.uint32)})


class TestCompact:
    def test_stable_selection(self):
        rng = np.random.default_rng(2)
        n = 1000
        t = Table.from_numpy({"k": _u64(rng, n),
                              "i": np.arange(n, dtype=np.uint32)})
        mask = jnp.asarray(rng.random(n) < 0.3)
        out, count = compact(t, mask)
        m = np.asarray(mask)
        c = int(count)
        assert c == m.sum()
        np.testing.assert_array_equal(
            np.asarray(out["i"])[:c], np.arange(n)[m])
        np.testing.assert_array_equal(
            out["k"].to_numpy()[:c], t["k"].to_numpy()[m])
        # rejected rows stable too
        np.testing.assert_array_equal(
            np.asarray(out["i"])[c:], np.arange(n)[~m])

    @pytest.mark.parametrize("frac", [0.0, 1.0])
    def test_all_or_nothing(self, frac):
        t = Table.from_numpy({"i": np.arange(64, dtype=np.uint32)})
        mask = jnp.asarray(np.full(64, frac == 1.0))
        out, count = compact(t, mask)
        assert int(count) == (64 if frac == 1.0 else 0)
        np.testing.assert_array_equal(np.asarray(out["i"]),
                                      np.arange(64, dtype=np.uint32))


class TestGroupAggregate:
    def _reference(self, keys, vals):
        order = np.argsort(keys, kind="stable")
        k, v = keys[order], vals[order]
        uk, starts = np.unique(k, return_index=True)
        ends = np.append(starts[1:], len(k))
        return uk, starts, ends, v

    def test_count_sum_min_max_u32(self):
        rng = np.random.default_rng(3)
        n = 4096
        keys = _u64(rng, n, hi=50)  # ~50 groups, many duplicates
        vals = rng.integers(0, 1000, size=n).astype(np.uint32)
        res = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                              aggs=("count", "sum", "min", "max"))
        g = int(res.num_groups)
        uk, starts, ends, v = self._reference(keys, vals)
        assert g == len(uk)
        np.testing.assert_array_equal(res.key.to_numpy()[:g], uk)
        np.testing.assert_array_equal(
            np.asarray(res.aggs["count"])[:g], ends - starts)
        want_sum = np.asarray(
            [v[s:e].sum(dtype=np.uint64) for s, e in zip(starts, ends)],
            dtype=np.uint64)  # EXACT u64 sums, not mod 2^32
        np.testing.assert_array_equal(res.aggs["sum"].to_numpy()[:g],
                                      want_sum)
        np.testing.assert_array_equal(
            np.asarray(res.aggs["min"])[:g],
            [v[s:e].min() for s, e in zip(starts, ends)])
        np.testing.assert_array_equal(
            np.asarray(res.aggs["max"])[:g],
            [v[s:e].max() for s, e in zip(starts, ends)])

    def test_float_min_max_with_negatives(self):
        rng = np.random.default_rng(4)
        n = 2048
        keys = _u64(rng, n, hi=20)
        vals = (rng.random(n).astype(np.float32) - 0.5) * 100
        res = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                              aggs=("min", "max"))
        g = int(res.num_groups)
        uk, starts, ends, v = self._reference(keys, vals)
        np.testing.assert_array_equal(
            np.asarray(res.aggs["min"])[:g],
            [v[s:e].min() for s, e in zip(starts, ends)])
        np.testing.assert_array_equal(
            np.asarray(res.aggs["max"])[:g],
            [v[s:e].max() for s, e in zip(starts, ends)])

    def test_float_sum_small_group_after_large_prefix(self):
        # Regression (ADVICE r1): float sums were differences of one GLOBAL
        # running cumsum, so a small group following a large prefix lost its
        # significant digits. With the per-segment scan the small group's
        # sum is computed from its own values only.
        n_big = 1 << 16
        keys = np.concatenate([
            np.zeros(n_big, dtype=np.uint64),          # group 0: huge sum
            np.full(4, 7, dtype=np.uint64),            # group 7: tiny sum
        ])
        vals = np.concatenate([
            np.full(n_big, 1.0e6, dtype=np.float32),   # prefix sum ~6.5e10
            np.full(4, 1.0e-3, dtype=np.float32),
        ])
        res = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                              aggs=("sum",))
        g = int(res.num_groups)
        assert g == 2
        sums = np.asarray(res.aggs["sum"])[:g]
        np.testing.assert_allclose(sums[0], n_big * 1.0e6, rtol=1e-6)
        # the old global-cumsum path returned 0.0 or garbage here
        np.testing.assert_allclose(sums[1], 4.0e-3, rtol=1e-5)

    def test_float_sum_valid_mask_precision(self):
        rng = np.random.default_rng(11)
        n = 4096
        keys = _u64(rng, n, hi=50)
        vals = rng.random(n).astype(np.float32)
        valid = rng.random(n) < 0.7
        res = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                              aggs=("sum", "count"),
                              valid=jnp.asarray(valid))
        g = int(res.num_groups)
        uk = np.unique(keys[valid])
        assert g == len(uk)
        np.testing.assert_array_equal(res.key.to_numpy()[:g], uk)
        want = [np.sort(vals[valid & (keys == k)]).astype(np.float64).sum()
                for k in uk]
        np.testing.assert_allclose(np.asarray(res.aggs["sum"])[:g], want,
                                   rtol=1e-5)

    def test_count_only(self):
        keys = np.array([5, 5, 5, 1, 1, 9], dtype=np.uint64)
        res = group_aggregate(U64.from_numpy(keys))
        g = int(res.num_groups)
        assert g == 3
        np.testing.assert_array_equal(res.key.to_numpy()[:g], [1, 5, 9])
        np.testing.assert_array_equal(np.asarray(res.aggs["count"])[:g],
                                      [2, 3, 1])

    def test_all_unique_and_all_same(self):
        keys = np.arange(256, dtype=np.uint64)
        res = group_aggregate(U64.from_numpy(keys))
        assert int(res.num_groups) == 256
        keys = np.zeros(256, dtype=np.uint64)
        res = group_aggregate(U64.from_numpy(keys))
        assert int(res.num_groups) == 1
        assert int(np.asarray(res.aggs["count"])[0]) == 256


class TestSearchSortedU64:
    def test_against_numpy(self):
        rng = np.random.default_rng(5)
        s = np.sort(_u64(rng, 1000))
        q = np.concatenate([_u64(rng, 500), s[::7]])  # misses + exact hits
        got_l = np.asarray(searchsorted_u64(
            U64.from_numpy(s), U64.from_numpy(q), side="left"))
        got_r = np.asarray(searchsorted_u64(
            U64.from_numpy(s), U64.from_numpy(q), side="right"))
        np.testing.assert_array_equal(got_l, np.searchsorted(s, q, "left"))
        np.testing.assert_array_equal(got_r, np.searchsorted(s, q, "right"))


class TestJoin:
    def test_fk_join(self):
        rng = np.random.default_rng(6)
        m = 500
        rkeys = np.unique(_u64(rng, m))  # unique right keys
        right = Table.from_numpy({
            "key": rkeys,
            "rval": np.arange(len(rkeys), dtype=np.uint32) * 10,
        })
        # left: half hits, half misses
        hit = rkeys[rng.integers(0, len(rkeys), size=300)]
        miss = _u64(rng, 300)
        lkeys = np.concatenate([hit, miss])
        left = Table.from_numpy({
            "key": lkeys,
            "lval": np.arange(len(lkeys), dtype=np.uint32),
        })
        res = join_fk(left, right, key="key")
        matched = np.asarray(res.matched)
        out = res.table.to_numpy()
        pos = {k: i for i, k in enumerate(rkeys)}
        for i, k in enumerate(lkeys):
            if k in pos:
                assert matched[i]
                assert out["rval"][i] == pos[k] * 10
            else:
                assert not matched[i] or k in pos

    def test_join_sorted_ranges(self):
        rng = np.random.default_rng(7)
        r = np.sort(_u64(rng, 2000, hi=100))  # duplicates
        l = _u64(rng, 300, hi=100)
        idx = join_sorted(U64.from_numpy(l), U64.from_numpy(r))
        np.testing.assert_array_equal(np.asarray(idx.start),
                                      np.searchsorted(r, l, "left"))
        np.testing.assert_array_equal(np.asarray(idx.end),
                                      np.searchsorted(r, l, "right"))


class TestScanJoin:
    def _mk(self, rng, n_r=500, n_l=600):
        rkeys = np.unique(_u64(rng, n_r))
        right = Table.from_numpy({
            "rval": (np.arange(len(rkeys), dtype=np.uint32) * 7 + 3),
        })
        hit = rkeys[rng.integers(0, len(rkeys), size=n_l // 2)]
        miss = _u64(rng, n_l - n_l // 2)
        lkeys = np.concatenate([hit, miss])
        left = Table.from_numpy({
            "lval": np.arange(len(lkeys), dtype=np.uint32),
        })
        return rkeys, right, lkeys, left

    def test_matches_oracle(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.join import join_fk_scan

        rng = np.random.default_rng(3)
        rkeys, right, lkeys, left = self._mk(rng)
        out, matched = join_fk_scan(left, right, U64.from_numpy(lkeys),
                                    U64.from_numpy(rkeys))
        o = out.to_numpy()
        matched = np.asarray(matched)
        pos = {int(k): i for i, k in enumerate(rkeys)}
        for i, k in enumerate(lkeys):
            # left columns must come back in original left order
            assert o["lval"][i] == i
            if int(k) in pos:
                assert matched[i], i
                assert o["rval"][i] == pos[int(k)] * 7 + 3
            else:
                assert not matched[i], i

    def test_float_right_values(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.join import join_fk_scan

        rng = np.random.default_rng(5)
        rkeys = np.unique(_u64(rng, 200))
        vals = rng.standard_normal(len(rkeys)).astype(np.float32)
        right = Table.from_numpy({"rv": vals})
        lkeys = rkeys[rng.integers(0, len(rkeys), 400)]
        left = Table.from_numpy({"li": np.arange(400, dtype=np.uint32)})
        out, matched = join_fk_scan(left, right, U64.from_numpy(lkeys),
                                    U64.from_numpy(rkeys))
        assert bool(np.all(np.asarray(matched)))
        o = out.to_numpy()
        pos = {int(k): i for i, k in enumerate(rkeys)}
        for i, k in enumerate(lkeys):
            assert o["rv"][i] == vals[pos[int(k)]]

    def test_empty_right_all_unmatched(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.join import join_fk_scan

        rng = np.random.default_rng(9)
        lkeys = _u64(rng, 64)
        left = Table.from_numpy({"li": np.arange(64, dtype=np.uint32)})
        right = Table.from_numpy({"rv": np.zeros(1, dtype=np.uint32)})
        rkeys = np.array([lkeys.max() + 1 if lkeys.max() < 2**64 - 1 else 0],
                         dtype=np.uint64)
        out, matched = join_fk_scan(left, right, U64.from_numpy(lkeys),
                                    U64.from_numpy(rkeys))
        assert not np.any(np.asarray(matched) & (lkeys != rkeys[0]))


class TestTableAPI:
    def test_sort_by_filter_group_join(self):
        from tpu_qe.pipeline import build_scene_index

        rng = np.random.default_rng(1)
        n = 1000
        keys = rng.integers(0, 8, n).astype(np.uint64)
        vals = rng.integers(0, 100, n, dtype=np.uint32)
        t = Table.from_numpy({"key": keys, "val": vals})

        s = t.sort_by("key")
        sk = s["key"].to_numpy()
        assert (np.diff(sk.astype(np.int64)) >= 0).all()

        # f32 columns survive sort_by bit-exactly (carried as bit patterns)
        tf = Table.from_numpy({"key": keys,
                               "f": rng.standard_normal(n).astype(np.float32)})
        sf = tf.sort_by("key")
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(np.asarray(sf["f"]),
                                      np.asarray(tf["f"])[order])

        ft, cnt = t.filter(lambda tb: tb["val"] < jnp.uint32(50))
        assert int(cnt) == int((vals < 50).sum())

        g = t.group_by("key", "val", aggs=("count", "sum"))
        ng = int(g.num_groups)
        assert ng == len(np.unique(keys))
        got = {int(k): int(c) for k, c in zip(
            g.key.to_numpy()[:ng], np.asarray(g.aggs["count"])[:ng])}
        import collections
        want = collections.Counter(int(k) for k in keys)
        assert got == dict(want)

        right = Table.from_numpy({
            "key": np.arange(8, dtype=np.uint64),
            "rv": np.arange(8, dtype=np.uint32) * 3})
        out, matched = t.join(right, key="key")
        assert bool(np.all(np.asarray(matched)))
        assert np.array_equal(np.asarray(out["rv"]),
                              (keys * 3).astype(np.uint32))

        # flagship pipeline smoke: sorted + same multiset of indices
        idx = build_scene_index()
        codes = idx.code.to_numpy()
        assert (np.diff(codes.astype(np.int64)) >= 0).all() or (
            np.array_equal(np.sort(codes), codes))
        assert sorted(np.asarray(idx.order)) == list(range(3000))


class TestJoinRegressions:
    def test_searchsorted_power_of_two_sizes(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.join import searchsorted_u64

        for m in (1, 2, 4, 1024):
            r = np.arange(m, dtype=np.uint64) * 3
            q = np.concatenate([r, r + 1, [r.max() + 10]])
            got = np.asarray(searchsorted_u64(U64.from_numpy(r),
                                              U64.from_numpy(q)))
            np.testing.assert_array_equal(got, np.searchsorted(r, q, "left"),
                                          err_msg=f"m={m}")

    def test_scan_join_u64_right_column(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.join import join_fk_scan

        rng = np.random.default_rng(8)
        rkeys = np.unique(_u64(rng, 100))
        rbig = rng.integers(0, 1 << 64, len(rkeys), dtype=np.uint64)
        right = Table.from_numpy({"big": rbig})
        lkeys = rkeys[rng.integers(0, len(rkeys), 200)]
        left = Table.from_numpy({"i": np.arange(200, dtype=np.uint32)})
        out, matched = join_fk_scan(left, right, U64.from_numpy(lkeys),
                                    U64.from_numpy(rkeys))
        assert np.all(np.asarray(matched))
        got = out["big"].to_numpy()
        pos = {int(k): i for i, k in enumerate(rkeys)}
        assert all(got[i] == rbig[pos[int(k)]] for i, k in enumerate(lkeys))

    def test_fk_join_finds_match_in_power_of_two_table(self):
        from tpu_qe.ops.join import join_fk
        rkeys = np.arange(1024, dtype=np.uint64) * 7
        right = Table.from_numpy({"key": rkeys,
                                  "v": np.arange(1024, dtype=np.uint32)})
        left = Table.from_numpy({"key": rkeys.copy(),
                                 "li": np.arange(1024, dtype=np.uint32)})
        res = join_fk(left, right, key="key")
        assert bool(np.all(np.asarray(res.matched)))
        assert np.array_equal(np.asarray(res.table["v"]),
                              np.arange(1024, dtype=np.uint32))


class TestFusedFilterAggregate:
    def test_valid_mask_equals_compact_then_aggregate(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.aggregate import group_aggregate

        rng = np.random.default_rng(12)
        n = 5000
        keys = rng.integers(0, 40, n).astype(np.uint64) * np.uint64(977)
        vals = rng.integers(0, 1000, n, dtype=np.uint32)
        mask = vals % 3 != 0

        k = U64.from_numpy(keys)
        fused = group_aggregate(k, jnp.asarray(vals),
                                aggs=("count", "sum", "min", "max"),
                                valid=jnp.asarray(mask))
        ref = group_aggregate(U64.from_numpy(keys[mask]),
                              jnp.asarray(vals[mask]),
                              aggs=("count", "sum", "min", "max"))
        ng = int(fused.num_groups)
        assert ng == int(ref.num_groups)
        for a in ("count", "sum", "min", "max"):
            np.testing.assert_array_equal(_agg_np(fused.aggs[a])[:ng],
                                          _agg_np(ref.aggs[a])[:ng])
        np.testing.assert_array_equal(fused.key.to_numpy()[:ng],
                                      ref.key.to_numpy()[:ng])

    def test_all_invalid(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.aggregate import group_aggregate

        keys = np.arange(100, dtype=np.uint64)
        g = group_aggregate(U64.from_numpy(keys),
                            jnp.ones(100, dtype=jnp.uint32),
                            aggs=("count",),
                            valid=jnp.zeros(100, dtype=bool))
        assert int(g.num_groups) == 0

    def test_all_valid_same_as_no_mask(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.aggregate import group_aggregate

        rng = np.random.default_rng(13)
        keys = rng.integers(0, 7, 512).astype(np.uint64)
        vals = rng.integers(0, 99, 512, dtype=np.uint32)
        a = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                            aggs=("sum",), valid=jnp.ones(512, bool))
        b = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                            aggs=("sum",))
        ng = int(a.num_groups)
        assert ng == int(b.num_groups)
        np.testing.assert_array_equal(a.aggs["sum"].to_numpy()[:ng],
                                      b.aggs["sum"].to_numpy()[:ng])


def test_searchsorted_all_ones_query_right_side():
    # regression: side="right" with u64::MAX queries used to overshoot to
    # m+1 via clamped out-of-bounds probes
    from tpu_qe.bits import U64
    from tpu_qe.ops.join import searchsorted_u64

    M = (1 << 64) - 1
    r = np.array([1, 2, M, M], dtype=np.uint64)
    q = np.array([M, 0, 2, 3], dtype=np.uint64)
    for side in ("left", "right"):
        got = np.asarray(searchsorted_u64(U64.from_numpy(r),
                                          U64.from_numpy(q), side=side))
        np.testing.assert_array_equal(got, np.searchsorted(r, q, side),
                                      err_msg=side)


def test_empty_inputs():
    from tpu_qe.bits import U64
    from tpu_qe.ops.aggregate import group_aggregate
    from tpu_qe.sort import sort_u64_numpy

    assert sort_u64_numpy(np.array([], dtype=np.uint64)).shape == (0,)
    g = group_aggregate(U64.from_numpy(np.array([], dtype=np.uint64)),
                        jnp.array([], dtype=jnp.uint32),
                        aggs=("count", "sum"))
    assert int(g.num_groups) == 0
    t = Table.from_numpy({"k": np.array([], dtype=np.uint32)})
    ft, cnt = t.filter(lambda tb: tb["k"] > 0)
    assert int(cnt) == 0


class TestMultiAggregate:
    def test_multi_column_vs_single(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.aggregate import group_aggregate, group_aggregate_multi

        rng = np.random.default_rng(17)
        n = 4000
        keys = rng.integers(0, 30, n).astype(np.uint64) * np.uint64(31)
        a = rng.integers(0, 1000, n, dtype=np.uint32)
        b = rng.standard_normal(n).astype(np.float32)

        k = U64.from_numpy(keys)
        m = group_aggregate_multi(
            k, {"a": jnp.asarray(a), "b": jnp.asarray(b)},
            {"a": ("count", "sum", "min", "max"), "b": ("min", "max")})
        ra = group_aggregate(k, jnp.asarray(a),
                             aggs=("count", "sum", "min", "max"))
        rb = group_aggregate(k, jnp.asarray(b), aggs=("min", "max"))
        ng = int(m.num_groups)
        assert ng == int(ra.num_groups) == int(rb.num_groups)
        np.testing.assert_array_equal(m.key.to_numpy()[:ng],
                                      ra.key.to_numpy()[:ng])
        for agg in ("count", "sum", "min", "max"):
            np.testing.assert_array_equal(_agg_np(m.aggs[f"a_{agg}"])[:ng],
                                          _agg_np(ra.aggs[agg])[:ng])
        for agg in ("min", "max"):
            np.testing.assert_array_equal(np.asarray(m.aggs[f"b_{agg}"])[:ng],
                                          np.asarray(rb.aggs[agg])[:ng])

    def test_multi_with_valid_mask(self):
        from tpu_qe.bits import U64
        from tpu_qe.ops.aggregate import group_aggregate, group_aggregate_multi

        rng = np.random.default_rng(18)
        n = 2000
        keys = rng.integers(0, 10, n).astype(np.uint64)
        a = rng.integers(0, 100, n, dtype=np.uint32)
        mask = a % 2 == 0
        m = group_aggregate_multi(U64.from_numpy(keys),
                                  {"a": jnp.asarray(a)},
                                  {"a": ("count", "min")},
                                  valid=jnp.asarray(mask))
        ref = group_aggregate(U64.from_numpy(keys[mask]),
                              jnp.asarray(a[mask]), aggs=("count", "min"))
        ng = int(m.num_groups)
        assert ng == int(ref.num_groups)
        np.testing.assert_array_equal(np.asarray(m.aggs["a_count"])[:ng],
                                      np.asarray(ref.aggs["count"])[:ng])
        np.testing.assert_array_equal(np.asarray(m.aggs["a_min"])[:ng],
                                      np.asarray(ref.aggs["min"])[:ng])

    @pytest.mark.parametrize("max_groups", [None, 1 << 12])
    def test_float_sum_error_is_per_group(self, max_groups):
        # f32 group sums must carry each group's own rounding error, not
        # the ulp of a running prefix over all rows before the group
        from tpu_qe.bits import U64
        from tpu_qe.ops.aggregate import group_aggregate_multi

        rng = np.random.default_rng(19)
        n, g = 1 << 18, 1 << 12
        keys = rng.integers(0, g, n).astype(np.uint64)
        f = rng.random(n, dtype=np.float32)
        m = group_aggregate_multi(U64.from_numpy(keys), {"f": jnp.asarray(f)},
                                  {"f": ("sum", "count")},
                                  max_groups=max_groups)
        ng = int(m.num_groups)
        want = np.bincount(keys.astype(np.int64), f.astype(np.float64), g)
        got = np.asarray(m.aggs["f_sum"])[:ng].astype(np.float64)
        np.testing.assert_allclose(got, want[m.key.to_numpy()[:ng]
                                             .astype(np.int64)], rtol=1e-5)


def test_table_group_by_multi():
    rng = np.random.default_rng(23)
    n = 1000
    t = Table.from_numpy({
        "key": rng.integers(0, 9, n).astype(np.uint64),
        "a": rng.integers(0, 50, n, dtype=np.uint32),
        "b": rng.standard_normal(n).astype(np.float32),
    })
    m = t.group_by_multi("key", {"a": ("sum",), "b": ("max",)})
    ng = int(m.num_groups)
    keys = t["key"].to_numpy()
    a = np.asarray(t["a"])
    b = np.asarray(t["b"])
    for i in range(ng):
        k = m.key.to_numpy()[i]
        sel = keys == k
        assert int(m.aggs["a_sum"].to_numpy()[i]) == a[sel].sum()  # exact
        assert float(np.asarray(m.aggs["b_max"])[i]) == b[sel].max()


class TestInnerJoin:
    """One-to-many materialized inner join (duplicate right keys)."""

    @staticmethod
    def _oracle(lkeys, rkeys):
        pairs = []
        import collections
        where = collections.defaultdict(list)
        for j, k in enumerate(rkeys):
            where[int(k)].append(j)
        for i, k in enumerate(lkeys):
            for j in where.get(int(k), ()):
                pairs.append((i, int(rkeys[j]), j))
        return pairs

    def test_duplicate_right_keys_vs_oracle(self):
        from tpu_qe.ops import join_inner
        rng = np.random.default_rng(8)
        n_l, n_r = 500, 300
        lkeys = rng.integers(0, 60, n_l).astype(np.uint64)
        rkeys = rng.integers(0, 60, n_r).astype(np.uint64)  # many dups
        rvals = np.arange(n_r, dtype=np.uint32) * 7 + 1
        lvals = np.arange(n_l, dtype=np.uint32) * 13 + 5
        left = Table.from_numpy({"key": lkeys, "lv": lvals})
        right = Table.from_numpy({"key": rkeys, "rv": rvals})
        want = self._oracle(lkeys, rkeys)
        res = join_inner(left, right, out_budget=len(want) + 37)
        m = int(res.num_out)
        assert m == len(want), (m, len(want))
        assert int(res.overflow) == 0
        out = res.table.to_numpy()
        got = sorted(zip(out["lv"][:m].tolist(), out["rv"][:m].tolist()))
        want_pairs = sorted((int(lvals[i]), int(rvals[j]))
                            for i, _, j in want)
        assert got == want_pairs

    def test_output_is_left_major_ordered(self):
        from tpu_qe.ops import join_inner
        lkeys = np.array([5, 3, 5], dtype=np.uint64)
        rkeys = np.array([5, 3, 5, 9], dtype=np.uint64)
        left = Table.from_numpy({"key": lkeys,
                                 "li": np.arange(3, dtype=np.uint32)})
        right = Table.from_numpy({"key": rkeys,
                                  "ri": np.arange(4, dtype=np.uint32)})
        res = join_inner(left, right, out_budget=16)
        m = int(res.num_out)
        assert m == 5  # left0 x {r0,r2}, left1 x {r1}, left2 x {r0,r2}
        out = res.table.to_numpy()
        # slots are ordered by left row, then right (sorted) order
        np.testing.assert_array_equal(out["li"][:m], [0, 0, 1, 2, 2])
        np.testing.assert_array_equal(sorted(out["ri"][:2]), [0, 2])
        np.testing.assert_array_equal(out["ri"][2:3], [1])

    def test_overflow_exact_count(self):
        from tpu_qe.ops import join_inner
        lkeys = np.full(10, 4, dtype=np.uint64)
        rkeys = np.full(10, 4, dtype=np.uint64)  # 100 output pairs
        left = Table.from_numpy({"key": lkeys})
        right = Table.from_numpy({"key": rkeys})
        res = join_inner(left, right, out_budget=32)
        assert int(res.num_out) == 100      # exact despite truncation
        assert int(res.overflow) == 1
        res2 = join_inner(left, right, out_budget=128)
        assert int(res2.num_out) == 100 and int(res2.overflow) == 0

    def test_no_matches_and_empty_right_rows(self):
        from tpu_qe.ops import join_inner
        lkeys = np.array([1, 2, 3], dtype=np.uint64)
        rkeys = np.array([7, 8], dtype=np.uint64)
        res = join_inner(Table.from_numpy({"key": lkeys}),
                         Table.from_numpy({"key": rkeys}), out_budget=8)
        assert int(res.num_out) == 0 and int(res.overflow) == 0

    def test_u64_value_columns_carried(self):
        from tpu_qe.ops import join_inner
        lkeys = np.array([2, 2, 9], dtype=np.uint64)
        rkeys = np.array([2, 9, 2], dtype=np.uint64)
        rbig = np.array([1 << 40, 2 << 40, 3 << 40], dtype=np.uint64)
        res = join_inner(
            Table.from_numpy({"key": lkeys}),
            Table.from_numpy({"key": rkeys, "big": rbig}), out_budget=16)
        m = int(res.num_out)
        assert m == 5
        out = res.table.to_numpy()
        got = sorted(out["big"][:m].tolist())
        assert got == sorted([1 << 40, 3 << 40, 1 << 40, 3 << 40, 2 << 40])

    def test_fuzz_vs_oracle(self):
        from tpu_qe.ops import join_inner
        rng = np.random.default_rng(99)
        for trial in range(5):
            n_l = int(rng.integers(1, 400))
            n_r = int(rng.integers(1, 400))
            kr = int(rng.integers(2, 40))
            lkeys = rng.integers(0, kr, n_l).astype(np.uint64)
            rkeys = rng.integers(0, kr, n_r).astype(np.uint64)
            want = self._oracle(lkeys, rkeys)
            res = join_inner(Table.from_numpy({"key": lkeys}),
                             Table.from_numpy({"key": rkeys}),
                             out_budget=max(len(want), 1) + 3)
            m = int(res.num_out)
            assert m == len(want), trial
            assert int(res.overflow) == 0
            li = np.asarray(res.left_index)[:m]
            got_keys = lkeys[li]
            want_li = np.array([i for i, _, _ in want])
            np.testing.assert_array_equal(np.sort(li), np.sort(want_li))
            rk_sorted = np.sort(rkeys)
            ri = np.asarray(res.right_index)[:m]
            np.testing.assert_array_equal(got_keys, rk_sorted[ri])


class TestSemiAntiJoin:
    def test_semi_and_anti_vs_oracle(self):
        rng = np.random.default_rng(15)
        n_l, n_r = 1 << 11, 1 << 9
        lkeys = rng.integers(0, 1500, n_l).astype(np.uint64)
        rkeys = np.unique(rng.integers(0, 1500, n_r).astype(np.uint64))
        left = Table.from_numpy({
            "key": lkeys, "v": np.arange(n_l, dtype=np.uint32)})
        right = Table.from_numpy({
            "key": rkeys,
            "r": np.arange(len(rkeys), dtype=np.uint32)})
        rset = set(int(k) for k in rkeys)
        want_semi = np.array([i for i, k in enumerate(lkeys)
                              if int(k) in rset], dtype=np.uint32)
        sem, c_s = left.join_semi(right)
        assert int(c_s) == len(want_semi)
        np.testing.assert_array_equal(
            np.asarray(sem["v"])[:len(want_semi)], want_semi)
        ant, c_a = left.join_anti(right)
        want_anti = np.array([i for i, k in enumerate(lkeys)
                              if int(k) not in rset], dtype=np.uint32)
        assert int(c_a) == len(want_anti)
        np.testing.assert_array_equal(
            np.asarray(ant["v"])[:len(want_anti)], want_anti)


def test_group_aggregate_mean():
    from tpu_qe.ops import group_aggregate
    rng = np.random.default_rng(9)
    n = 4096
    keys = rng.integers(0, 30, n).astype(np.uint64)
    # float path
    fvals = rng.random(n).astype(np.float32) * 10
    res = group_aggregate(U64.from_numpy(keys), jnp.asarray(fvals),
                          aggs=("mean", "count"))
    g = int(res.num_groups)
    uk = np.unique(keys)
    assert g == len(uk)
    want = [fvals[keys == k].astype(np.float64).mean() for k in uk]
    np.testing.assert_allclose(np.asarray(res.aggs["mean"])[:g], want,
                               rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(res.aggs["count"])[:g],
        [int((keys == k).sum()) for k in uk])
    # integer path (sums fit u32)
    ivals = rng.integers(0, 1000, n, dtype=np.uint32)
    res = group_aggregate(U64.from_numpy(keys), jnp.asarray(ivals),
                          aggs=("mean",))
    want = [ivals[keys == k].astype(np.float64).mean() for k in uk]
    np.testing.assert_allclose(np.asarray(res.aggs["mean"])[:g], want,
                               rtol=1e-5)


class TestExactU64Sums:
    """Integer GROUP BY sums past 2^32 must be exact (repo convention:
    never silently truncate). Values near u32 max so a handful of rows
    overflows a 32-bit accumulator many times over."""

    def test_group_sums_past_2_32(self):
        rng = np.random.default_rng(77)
        n = 4096
        keys = rng.integers(0, 8, n).astype(np.uint64)
        vals = (rng.integers(1 << 31, 1 << 32, n).astype(np.uint64)
                .astype(np.uint32))
        res = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                              aggs=("sum", "count"))
        g = int(res.num_groups)
        got = res.aggs["sum"].to_numpy()[:g]
        gk = res.key.to_numpy()[:g]
        for i, k in enumerate(gk):
            want = int(vals[keys == k].astype(np.uint64).sum())
            assert want > (1 << 32)  # the test is vacuous otherwise
            assert int(got[i]) == want

    def test_max_groups_path_past_2_32(self):
        rng = np.random.default_rng(78)
        n = 2048
        keys = rng.integers(0, 4, n).astype(np.uint64)
        vals = np.full(n, 0xF0000000, dtype=np.uint32)
        res = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                              aggs=("sum",), max_groups=8)
        g = int(res.num_groups)
        got = res.aggs["sum"].to_numpy()[:g]
        gk = res.key.to_numpy()[:g]
        for i, k in enumerate(gk):
            want = int((keys == k).sum()) * 0xF0000000
            assert want > (1 << 32)
            assert int(got[i]) == want

    def test_multi_column_past_2_32(self):
        from tpu_qe.ops.aggregate import group_aggregate_multi
        rng = np.random.default_rng(79)
        n = 2048
        keys = rng.integers(0, 4, n).astype(np.uint64)
        a = np.full(n, 0xE0000000, dtype=np.uint32)
        m = group_aggregate_multi(U64.from_numpy(keys),
                                  {"a": jnp.asarray(a)}, {"a": ("sum",)})
        g = int(m.num_groups)
        got = m.aggs["a_sum"].to_numpy()[:g]
        gk = m.key.to_numpy()[:g]
        for i, k in enumerate(gk):
            want = int((keys == k).sum()) * 0xE0000000
            assert want > (1 << 32)
            assert int(got[i]) == want

    def test_multi_column_int32_negatives_signed_exact(self):
        # int32 sums sign-extend into the hi plane: the U64 pair is the
        # exact SIGNED group sum in two's complement (i64-in-U64), both
        # in the compaction path and the max_groups gather path
        from tpu_qe.ops.aggregate import group_aggregate_multi
        rng = np.random.default_rng(83)
        n = 4096
        keys = rng.integers(0, 7, n).astype(np.uint64)
        a = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
        assert (a < 0).any()
        for mg in (None, 16):
            m = group_aggregate_multi(U64.from_numpy(keys),
                                      {"a": jnp.asarray(a)},
                                      {"a": ("sum", "min", "max")},
                                      max_groups=mg)
            g = int(m.num_groups)
            got = m.aggs["a_sum"].to_numpy()[:g].astype(np.int64)
            gk = m.key.to_numpy()[:g]
            want = np.array([a[keys == k].astype(np.int64).sum()
                             for k in gk])
            assert want.min() < 0 or want.max() > (1 << 31)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                np.asarray(m.aggs["a_min"])[:g],
                [a[keys == k].min() for k in gk])

    def test_mean_uses_exact_sum(self):
        keys = np.zeros(1024, dtype=np.uint64)
        vals = np.full(1024, 0xF0000000, dtype=np.uint32)
        res = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                              aggs=("mean",))
        got = float(np.asarray(res.aggs["mean"])[0])
        np.testing.assert_allclose(got, float(0xF0000000), rtol=1e-6)


class TestMaxGroupsExtraction:
    """group_aggregate(max_groups=...): gather-based group extraction must
    equal the sort-based default on the valid prefix."""

    @pytest.mark.parametrize("dtype", ["uint32", "float32"])
    def test_matches_default_path(self, dtype):
        from tpu_qe.ops import group_aggregate
        rng = np.random.default_rng(31)
        n = 1 << 13
        keys = _u64(rng, n, hi=200)
        if dtype == "uint32":
            vals = rng.integers(0, 1000, n, dtype=np.uint32)
        else:
            vals = (rng.standard_normal(n) * 5).astype(np.float32)
        aggs = ("count", "sum", "min", "max")
        base = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                               aggs=aggs)
        fast = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                               aggs=aggs, max_groups=256)
        g = int(base.num_groups)
        assert int(fast.num_groups) == g
        assert int(fast.overflow) == 0
        np.testing.assert_array_equal(fast.key.to_numpy()[:g],
                                      base.key.to_numpy()[:g])
        for a in aggs:
            np.testing.assert_array_equal(
                _agg_np(fast.aggs[a])[:g], _agg_np(base.aggs[a])[:g],
                err_msg=a)

    def test_valid_mask(self):
        from tpu_qe.ops import group_aggregate
        rng = np.random.default_rng(32)
        n = 1 << 12
        keys = _u64(rng, n, hi=64)
        vals = rng.integers(0, 100, n, dtype=np.uint32)
        valid = rng.random(n) < 0.6
        base = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                               aggs=("count", "sum"),
                               valid=jnp.asarray(valid))
        fast = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                               aggs=("count", "sum"),
                               valid=jnp.asarray(valid), max_groups=128)
        g = int(base.num_groups)
        assert int(fast.num_groups) == g and int(fast.overflow) == 0
        np.testing.assert_array_equal(fast.key.to_numpy()[:g],
                                      base.key.to_numpy()[:g])
        np.testing.assert_array_equal(fast.aggs["sum"].to_numpy()[:g],
                                      base.aggs["sum"].to_numpy()[:g])

    def test_overflow_exact_count(self):
        from tpu_qe.ops import group_aggregate
        keys = np.arange(100, dtype=np.uint64)
        res = group_aggregate(U64.from_numpy(keys), max_groups=16)
        assert int(res.num_groups) == 100  # exact despite truncation
        assert int(res.overflow) == 1
        # the first 16 groups are still correct
        np.testing.assert_array_equal(res.key.to_numpy()[:16],
                                      np.arange(16, dtype=np.uint64))

    def test_mean_with_max_groups(self):
        from tpu_qe.ops import group_aggregate
        keys = np.array([1, 1, 2, 2, 2], dtype=np.uint64)
        vals = np.array([2, 4, 3, 6, 9], dtype=np.uint32)
        res = group_aggregate(U64.from_numpy(keys), jnp.asarray(vals),
                              aggs=("mean",), max_groups=8)
        np.testing.assert_allclose(np.asarray(res.aggs["mean"])[:2],
                                   [3.0, 6.0])


class TestStreamJoinAndSortedAggregate:
    """join_fk_scan(output="stream") + group_aggregate_sorted: the fused
    join -> GROUP BY pipeline (two large sorts instead of four)."""

    @staticmethod
    def _mk(rng, n_l, n_r):
        rkeys = np.unique(rng.integers(0, 1 << 48, 2 * n_r,
                                       dtype=np.uint64))[:n_r]
        rvals = rng.integers(1, 1000, len(rkeys), dtype=np.uint32)
        hit = rng.random(n_l) < 0.6
        lkeys = np.where(hit, rkeys[rng.integers(0, len(rkeys), n_l)],
                         rng.integers(0, 1 << 48, n_l, dtype=np.uint64)
                         | (np.uint64(1) << np.uint64(49)))
        return lkeys, rkeys, rvals

    def test_stream_matches_left_output(self):
        from tpu_qe.ops.join import join_fk_scan
        rng = np.random.default_rng(41)
        lkeys, rkeys, rvals = self._mk(rng, 3000, 500)
        lk, rk = U64.from_numpy(lkeys), U64.from_numpy(rkeys)
        left = Table({"lv": jnp.arange(len(lkeys), dtype=jnp.uint32)})
        right = Table({"rv": jnp.asarray(rvals)})
        out, matched = join_fk_scan(left, right, lk, rk)
        st = join_fk_scan(left, right, lk, rk, output="stream")
        # the stream's left rows, restored by lidx, must agree row-for-row
        lidx = np.asarray(st.lidx)
        is_left = np.asarray(st.is_left)
        m_s = np.asarray(st.matched)[is_left]
        rv_s = np.asarray(st.values["rv"])[is_left]
        order = lidx[is_left]
        got_m = np.zeros(len(lkeys), bool)
        got_rv = np.zeros(len(lkeys), np.uint32)
        got_m[order] = m_s
        got_rv[order] = rv_s
        np.testing.assert_array_equal(got_m, np.asarray(matched))
        np.testing.assert_array_equal(got_rv, np.asarray(out["rv"]))
        # and the stream keys must be sorted
        sk = st.key.to_numpy()
        assert (np.sort(sk) == sk).all()

    def test_sorted_aggregate_matches_group_aggregate(self):
        from tpu_qe.ops.aggregate import group_aggregate_sorted
        rng = np.random.default_rng(42)
        n = 6000
        keys = np.sort(rng.integers(0, 64, n).astype(np.uint64) * 977)
        vals = rng.integers(0, 100000, n, dtype=np.uint32)
        valid = rng.random(n) < 0.7
        a = group_aggregate_sorted(U64.from_numpy(keys), jnp.asarray(vals),
                                   aggs=("count", "sum", "min", "max"),
                                   valid=jnp.asarray(valid))
        b = group_aggregate(U64.from_numpy(keys[valid]),
                            jnp.asarray(vals[valid]),
                            aggs=("count", "sum", "min", "max"))
        ng = int(a.num_groups)
        assert ng == int(b.num_groups)
        np.testing.assert_array_equal(a.key.to_numpy()[:ng],
                                      b.key.to_numpy()[:ng])
        for agg in ("count", "sum", "min", "max"):
            np.testing.assert_array_equal(_agg_np(a.aggs[agg])[:ng],
                                          _agg_np(b.aggs[agg])[:ng],
                                          err_msg=agg)

    def test_sorted_aggregate_float_and_mean(self):
        from tpu_qe.ops.aggregate import group_aggregate_sorted
        rng = np.random.default_rng(43)
        n = 4096
        keys = np.sort(rng.integers(0, 16, n).astype(np.uint64))
        vals = rng.standard_normal(n).astype(np.float32)
        res = group_aggregate_sorted(U64.from_numpy(keys),
                                     jnp.asarray(vals),
                                     aggs=("sum", "mean", "count"))
        ng = int(res.num_groups)
        gk = res.key.to_numpy()[:ng]
        for i, k in enumerate(gk):
            sel = vals[keys == k]
            np.testing.assert_allclose(float(np.asarray(res.aggs["sum"])[i]),
                                       sel.sum(dtype=np.float64), rtol=1e-4)
            np.testing.assert_allclose(
                float(np.asarray(res.aggs["mean"])[i]), sel.mean(), rtol=1e-4)

    def test_fused_join_groupby_pipeline(self):
        # SELECT lkey, count(*), sum(rv) FROM left JOIN right GROUP BY
        # lkey — fused via the stream, oracled via numpy
        from tpu_qe.ops.aggregate import group_aggregate_sorted
        from tpu_qe.ops.join import join_fk_scan
        rng = np.random.default_rng(44)
        lkeys, rkeys, rvals = self._mk(rng, 5000, 800)
        lk, rk = U64.from_numpy(lkeys), U64.from_numpy(rkeys)
        st = join_fk_scan(Table({"z": jnp.zeros(len(lkeys), jnp.uint32)}),
                          Table({"rv": jnp.asarray(rvals)}), lk, rk,
                          output="stream")
        res = group_aggregate_sorted(st.key, st.values["rv"],
                                     aggs=("count", "sum"),
                                     valid=st.matched)
        ng = int(res.num_groups)
        gk = res.key.to_numpy()[:ng]
        pos = {int(k): int(v) for k, v in zip(rkeys, rvals)}
        import collections
        want_cnt = collections.Counter()
        want_sum = collections.defaultdict(int)
        for k in lkeys:
            if int(k) in pos:
                want_cnt[int(k)] += 1
                want_sum[int(k)] += pos[int(k)]
        assert ng == len(want_cnt)
        assert sorted(int(x) for x in gk) == sorted(want_cnt)
        for i, k in enumerate(gk):
            assert int(np.asarray(res.aggs["count"])[i]) == want_cnt[int(k)]
            assert int(res.aggs["sum"].to_numpy()[i]) == want_sum[int(k)]

    def test_sorted_aggregate_empty_and_all_invalid(self):
        from tpu_qe.ops.aggregate import group_aggregate_sorted
        e = group_aggregate_sorted(
            U64.from_numpy(np.array([], dtype=np.uint64)),
            jnp.array([], dtype=jnp.uint32), aggs=("count", "sum"))
        assert int(e.num_groups) == 0
        keys = np.sort(np.arange(64, dtype=np.uint64) % 8)
        z = group_aggregate_sorted(U64.from_numpy(keys),
                                   jnp.ones(64, jnp.uint32),
                                   aggs=("count",),
                                   valid=jnp.zeros(64, bool))
        assert int(z.num_groups) == 0


class TestMultiMaxGroups:
    """max_groups extraction for group_aggregate_multi (the SQL-shaped
    multi-column path gains the measured low-cardinality trade)."""

    def test_matches_default_path(self):
        from tpu_qe.ops.aggregate import group_aggregate_multi
        rng = np.random.default_rng(91)
        n = 8192
        keys = rng.integers(0, 60, n).astype(np.uint64) * np.uint64(131)
        a = rng.integers(0, 1 << 31, n, dtype=np.uint32)
        b = rng.standard_normal(n).astype(np.float32)
        k = U64.from_numpy(keys)
        spec = {"a": ("count", "sum", "min", "max"), "b": ("sum", "max")}
        vals = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
        base = group_aggregate_multi(k, vals, spec)
        fast = group_aggregate_multi(k, vals, spec, max_groups=128)
        g = int(base.num_groups)
        assert int(fast.num_groups) == g and int(fast.overflow) == 0
        np.testing.assert_array_equal(fast.key.to_numpy()[:g],
                                      base.key.to_numpy()[:g])
        for name in ("a_count", "a_sum", "a_min", "a_max", "b_max"):
            np.testing.assert_array_equal(_agg_np(fast.aggs[name])[:g],
                                          _agg_np(base.aggs[name])[:g],
                                          err_msg=name)
        np.testing.assert_allclose(np.asarray(fast.aggs["b_sum"])[:g],
                                   np.asarray(base.aggs["b_sum"])[:g],
                                   rtol=1e-5)

    def test_valid_mask_and_exact_u64(self):
        from tpu_qe.ops.aggregate import group_aggregate_multi
        rng = np.random.default_rng(92)
        n = 4096
        keys = rng.integers(0, 8, n).astype(np.uint64)
        a = np.full(n, 0xF0000000, dtype=np.uint32)
        mask = rng.random(n) < 0.5
        res = group_aggregate_multi(U64.from_numpy(keys),
                                    {"a": jnp.asarray(a)},
                                    {"a": ("count", "sum")},
                                    valid=jnp.asarray(mask),
                                    max_groups=16)
        g = int(res.num_groups)
        gk = res.key.to_numpy()[:g]
        for i, k in enumerate(gk):
            cnt = int(((keys == k) & mask).sum())
            assert int(np.asarray(res.aggs["a_count"])[i]) == cnt
            want = cnt * 0xF0000000
            assert want > (1 << 32)
            assert int(res.aggs["a_sum"].to_numpy()[i]) == want

    def test_overflow_flag(self):
        from tpu_qe.ops.aggregate import group_aggregate_multi
        keys = np.arange(100, dtype=np.uint64)
        res = group_aggregate_multi(U64.from_numpy(keys),
                                    {"a": jnp.ones(100, jnp.uint32)},
                                    {"a": ("count",)}, max_groups=16)
        assert int(res.num_groups) == 100   # exact past the bound
        assert int(res.overflow) == 1


def test_stream_with_u64_right_column():
    from tpu_qe.ops.join import join_fk_scan
    rng = np.random.default_rng(45)
    lkeys, rkeys, _ = TestStreamJoinAndSortedAggregate._mk(rng, 2000, 300)
    rpay = rng.integers(0, 1 << 64, len(rkeys), dtype=np.uint64)
    lk, rk = U64.from_numpy(lkeys), U64.from_numpy(rkeys)
    right = Table({"rp": U64.from_numpy(rpay)})
    left = Table({"z": jnp.zeros(len(lkeys), jnp.uint32)})
    out, matched = join_fk_scan(left, right, lk, rk)
    st = join_fk_scan(left, right, lk, rk, output="stream")
    is_left = np.asarray(st.is_left)
    order = np.asarray(st.lidx)[is_left]
    got = np.zeros(len(lkeys), np.uint64)
    got[order] = st.values["rp"].to_numpy()[is_left]
    np.testing.assert_array_equal(got, out["rp"].to_numpy())
