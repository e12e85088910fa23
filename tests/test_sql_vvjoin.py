"""Virtual x virtual JOIN -> GROUP BY (sql/bigexec._vv_agg_partials):
both sides of the join are out-of-core virtual tables — neither ever
crosses to the host. Oracle: the in-core SQL engine over the SAME
materialized data.

The run_size is chosen so the bucket plan cuts MULTIPLE key-space
buckets (n_f + n_d > run_size), fact keys repeat (FK one-to-many on
the left), and the dimension covers only part of the fact key space
(LEFT joins surface real unmatched rows)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_qe.hashing import murmur_fmix32
from tpu_qe.sql import Database, SqlError

NF = (1 << 12) * 3 + 17         # fact rows (non-dividing tail)
ND = 1 << 9                     # dimension rows (unique keys 0..511)
RUN = 1 << 12                   # (NF+ND)/RUN -> 4 key-space buckets


def _fact_gens():
    return {
        # fact key hits 0..767: values >= 512 have no dimension match
        "fk": lambda i: murmur_fmix32(i) % jnp.uint32(768),
        "v": lambda i: ((murmur_fmix32(i ^ jnp.uint32(0xA5A5))
                         & jnp.uint32(0xFFFF)).astype(jnp.int32)
                        - jnp.int32(0x8000)),
        "u": lambda i: murmur_fmix32(i ^ jnp.uint32(7)) & jnp.uint32(999),
        "id": lambda i: i,
    }


def _dim_gens():
    return {
        "dk": lambda i: i,                                   # unique
        "w": lambda i: (i * jnp.uint32(2654435761)) >> jnp.uint32(22),
        "grp": lambda i: i & jnp.uint32(15),
        "fw": lambda i: (i.astype(jnp.float32)
                         * jnp.float32(0.25)),
    }


@pytest.fixture(scope="module")
def dbs():
    big = Database()
    big.register_virtual("f", NF, _fact_gens())
    big.register_virtual("d", ND, _dim_gens())
    ref = Database()
    fi = jnp.arange(NF, dtype=jnp.uint32)
    di = jnp.arange(ND, dtype=jnp.uint32)
    ref.register("f", {nm: np.asarray(fn(fi))
                       for nm, fn in _fact_gens().items()})
    ref.register("d", {nm: np.asarray(fn(di))
                       for nm, fn in _dim_gens().items()})
    return big, ref


def _cmp(got: dict, want: dict, float_cols=(), rtol=1e-5, atol=1e-3):
    assert sorted(got) == sorted(want)
    names = sorted(want)
    pg = np.lexsort([np.asarray(got[n]).astype(np.float64)
                     for n in reversed(names)])
    pw = np.lexsort([np.asarray(want[n]).astype(np.float64)
                     for n in reversed(names)])
    for n in names:
        a, b = np.asarray(got[n])[pg], np.asarray(want[n])[pw]
        assert len(a) == len(b), (n, len(a), len(b))
        if n in float_cols or a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64),
                                       rtol=rtol, atol=atol, err_msg=n)
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=n)


def test_inner_group_by_dim_col(dbs):
    big, ref = dbs
    sql = ("SELECT grp, COUNT(*) AS c, SUM(u) AS s "
           "FROM f JOIN d ON fk = dk GROUP BY grp ORDER BY grp")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_inner_group_by_fact_expr(dbs):
    big, ref = dbs
    sql = ("SELECT fk % 7 AS m, COUNT(*) AS c, SUM(w) AS sw, "
           "MIN(v) AS mn, MAX(v) AS mx "
           "FROM f JOIN d ON fk = dk GROUP BY m ORDER BY m")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_cross_side_expression_and_avg(dbs):
    big, ref = dbs
    sql = ("SELECT grp, SUM(u * w) AS sp, AVG(fw) AS a "
           "FROM f JOIN d ON fk = dk GROUP BY grp ORDER BY grp")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql),
         float_cols=("a",), rtol=1e-4)


def test_where_both_sides(dbs):
    big, ref = dbs
    sql = ("SELECT grp, COUNT(*) AS c, SUM(v) AS s "
           "FROM f JOIN d ON fk = dk "
           "WHERE u % 3 = 0 AND w % 2 = 1 "
           "GROUP BY grp ORDER BY grp")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_global_aggregate_no_group(dbs):
    big, ref = dbs
    sql = ("SELECT COUNT(*) AS c, SUM(w) AS s, MIN(w) AS mn, "
           "MAX(w) AS mx FROM f JOIN d ON fk = dk")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_left_join_matched_mask(dbs):
    big, ref = dbs
    # unmatched fact rows (fk >= 512) group under d__matched = 0 with
    # NULL-zero w fills — the engine's documented NULL convention
    sql = ("SELECT d__matched AS m, COUNT(*) AS c, SUM(w) AS s "
           "FROM f LEFT JOIN d ON fk = dk GROUP BY m ORDER BY m")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_left_join_group_by_dim_key(dbs):
    big, ref = dbs
    # GROUP BY the dim-side join key itself (regenerated from the
    # joined row index; unmatched rows take the zero fill)
    sql = ("SELECT dk, COUNT(*) AS c FROM f LEFT JOIN d ON fk = dk "
           "GROUP BY dk ORDER BY dk")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_two_column_group_by(dbs):
    big, ref = dbs
    sql = ("SELECT grp, fk % 3 AS m, COUNT(*) AS c, SUM(u) AS s "
           "FROM f JOIN d ON fk = dk GROUP BY grp, m "
           "ORDER BY grp, m")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_having_and_limit(dbs):
    big, ref = dbs
    sql = ("SELECT grp, COUNT(*) AS c FROM f JOIN d ON fk = dk "
           "GROUP BY grp HAVING COUNT(*) > 200 "
           "ORDER BY c DESC, grp LIMIT 5")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_signed_i32_sums_exact(dbs):
    big, ref = dbs
    # v is int32 with negatives: partial sums must combine as exact
    # signed i64 (the sum_signed path), never u32 bit patterns
    sql = ("SELECT grp, SUM(v) AS s FROM f JOIN d ON fk = dk "
           "GROUP BY grp ORDER BY grp")
    _cmp(big.sql(sql, run_size=RUN), ref.sql(sql))


def test_single_bucket_path(dbs):
    big, ref = dbs
    # run_size > n_f + n_d -> n_buckets == 1 (no splitter plan at all)
    sql = ("SELECT grp, COUNT(*) AS c FROM f JOIN d ON fk = dk "
           "GROUP BY grp ORDER BY grp")
    _cmp(big.sql(sql, run_size=1 << 15), ref.sql(sql))


def test_duplicate_dim_keys_raise():
    db = Database()
    db.register_virtual("f", 1 << 10, {"fk": lambda i: i & jnp.uint32(7),
                                       "v": lambda i: i})
    db.register_virtual("d", 16, {"dk": lambda i: i & jnp.uint32(7),
                                  "w": lambda i: i})
    with pytest.raises(SqlError, match="not unique"):
        db.sql("SELECT w, COUNT(*) AS c FROM f JOIN d ON fk = dk "
               "GROUP BY w", run_size=1 << 9)


def test_non_aggregate_vv_raises(dbs):
    big, _ = dbs
    with pytest.raises(SqlError, match="aggregate queries only"):
        big.sql("SELECT fk, w FROM f JOIN d ON fk = dk LIMIT 8",
                run_size=RUN)


def test_percentile_over_vv_raises(dbs):
    big, _ = dbs
    with pytest.raises(SqlError, match="virtual x\\s*virtual JOIN"):
        big.sql("SELECT grp, MEDIAN(v) AS md FROM f JOIN d ON fk = dk "
                "GROUP BY grp", run_size=RUN)
