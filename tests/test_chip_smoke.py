"""chip_smoke.py at CPU size: every phase against its reference, the numpy
references themselves against sqlite3, and the refusal to run without a GPU.

The phase functions are the ones chip_smoke.py runs on the card; here they
run at a few thousand rows on the CPU backend (the suite's 8 virtual
devices give the four-card phases their mesh).
"""

import json
import os
import shutil
import sqlite3
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from tpu_qe.exchange.dsort import make_mesh

N_FACT, N_DIM = 1 << 12, 1 << 6


@pytest.fixture(scope="module")
def clock():
    return cs.CompileClock()


@pytest.fixture(scope="module")
def tables():
    return cs.make_tables(N_FACT, N_DIM)


@pytest.fixture(scope="module")
def sqlite_db(tables):
    fact, dim = tables
    con = sqlite3.connect(":memory:")
    con.execute("CREATE TABLE t (k INTEGER, v INTEGER, f REAL, id INTEGER)")
    con.execute("CREATE TABLE d (dk INTEGER, g INTEGER, w INTEGER)")
    con.executemany("INSERT INTO t VALUES (?, ?, ?, ?)", zip(
        fact["k"].tolist(), fact["v"].tolist(),
        fact["f"].astype(np.float64).tolist(), fact["id"].tolist()))
    con.executemany("INSERT INTO d VALUES (?, ?, ?)", zip(
        dim["dk"].tolist(), dim["g"].tolist(), dim["w"].tolist()))
    return con


def _rows(con, sql):
    return np.array(con.execute(sql).fetchall(), dtype=np.float64)


def test_phase_sort_bit_exact(clock):
    (line,) = cs.phase_sort(12, clock)
    assert line["keys_bit_exact"] and line["order_bit_exact"], line
    assert line["sort_lowering"]["xla_sort_ops"] >= 1


@pytest.mark.parametrize("name", list(cs.sql_queries(N_FACT)))
def test_sql_query_matches_numpy(tables, name):
    from tpu_qe.sql import Database
    fact, dim = tables
    db = Database()
    db.register("t", fact)
    db.register("d", dim)
    out = db.sql(cs.sql_queries(N_FACT)[name])
    assert cs.check_query(name, out, fact, dim) is None


def test_phase_sql_lines(clock):
    lines = cs.phase_sql(11, 5, clock)
    assert [ln["phase"] for ln in lines] == [
        f"B_sql_{name}" for name in cs.sql_queries(1 << 11)]
    assert all(ln["ok"] and ln["seconds"] > 0 for ln in lines), lines


def test_phase_bigsql_closed_form(clock):
    (line,) = cs.phase_bigsql(14, 4, 12, clock)
    assert line["ok"], line


# --- the numpy references against sqlite3 ----------------------------------

def test_ref_group_where_vs_sqlite(tables, sqlite_db):
    fact, _ = tables
    want = _rows(sqlite_db, "SELECT k, COUNT(*), SUM(v), AVG(f) FROM t "
                            "WHERE v % 4 <> 0 GROUP BY k ORDER BY k")
    got = cs.ref_group_where(fact, N_DIM)
    np.testing.assert_array_equal(got["k"], want[:, 0])
    np.testing.assert_array_equal(got["c"], want[:, 1])
    np.testing.assert_array_equal(got["s"], want[:, 2])
    np.testing.assert_allclose(got["af"], want[:, 3], rtol=1e-12)


def test_ref_join_having_vs_sqlite(tables, sqlite_db):
    fact, dim = tables
    thr = N_FACT // 1024
    want = _rows(sqlite_db, "SELECT d.g, COUNT(*) AS c, SUM(t.v) AS s "
                            "FROM t JOIN d ON t.k = d.dk GROUP BY d.g "
                            f"HAVING COUNT(*) > {thr} "
                            "ORDER BY s DESC, d.g LIMIT 10")
    got = cs.ref_join_having(fact, dim, thr, 10)
    np.testing.assert_array_equal(
        np.stack([got["g"], got["c"], got["s"]], 1), want)


def test_ref_window_vs_sqlite(tables, sqlite_db):
    fact, _ = tables
    want = _rows(sqlite_db, "SELECT id, ROW_NUMBER() OVER (PARTITION BY k "
                            "ORDER BY id), SUM(v) OVER (PARTITION BY k "
                            "ORDER BY id) FROM t ORDER BY id")
    got = cs.ref_window(fact)
    np.testing.assert_array_equal(got["rn"], want[:, 1])
    np.testing.assert_array_equal(got["rs"], want[:, 2])


def test_ref_order_limit_vs_sqlite(tables, sqlite_db):
    fact, _ = tables
    want = _rows(sqlite_db, "SELECT id, k, v FROM t "
                            "ORDER BY k DESC, v, id LIMIT 100")
    got = cs.ref_order_limit(fact, 100)
    np.testing.assert_array_equal(
        np.stack([got["id"], got["k"], got["v"]], 1), want)


def test_ref_percentile_disc_vs_sqlite(tables, sqlite_db):
    # PERCENTILE_DISC(0.9): the first row whose row number reaches
    # 0.9 * count, computed in double like PostgreSQL's percentile_disc
    fact, _ = tables
    want = _rows(sqlite_db, "SELECT k, MIN(v) FROM (SELECT k, v, "
                            "ROW_NUMBER() OVER (PARTITION BY k ORDER BY v) "
                            "AS rn, COUNT(*) OVER (PARTITION BY k) AS c "
                            "FROM t) WHERE rn >= 0.9 * c GROUP BY k "
                            "ORDER BY k")
    got = cs.ref_percentile_disc(fact, N_DIM, 0.9)
    np.testing.assert_array_equal(np.stack([got["k"], got["p"]], 1), want)


# --- the four-card phases on a 4-device CPU mesh ---------------------------

def test_phase_mesh_sort(clock):
    (line,) = cs.phase_mesh_sort(12, make_mesh(4), clock)
    assert line["ok"] and len(line["placement"]) == 4, line
    assert sum(line["rows_per_device"]) == 1 << 12


@pytest.mark.parametrize("zipf", [None, cs.MESH_ZIPF])
def test_mesh_queries_match_numpy(zipf):
    from tpu_qe.sql import Database
    fact, dim = cs.make_tables(1 << 13, 1 << 8, zipf=zipf, signed=False)
    db = Database()
    db.register("t", fact)
    db.register("d", dim)
    mesh = make_mesh(4)
    q = cs.mesh_queries(1 << 13)
    assert cs.check_query("i_group_where", db.sql(q["i_group_where"],
                                                  mesh=mesh), fact, dim) \
        is None
    out = db.sql(q["ii_join_order_limit"], mesh=mesh)
    want = cs.ref_mesh_join(fact, dim, 100)
    assert cs._same_ints(out, want, ("k", "c", "s"))


def test_phase_mesh_sql_lines(clock):
    lines = cs.phase_mesh_sql(12, 7, make_mesh(4), clock)
    assert len(lines) == 2 and all(ln["ok"] for ln in lines), lines
    assert lines[0]["hottest_key_share"] > 0.05     # Zipf(1.1) head


# --- measurement helpers ---------------------------------------------------

def test_compile_clock_counts_first_call_only():
    import jax
    import jax.numpy as jnp
    clock = cs.CompileClock()
    f = jax.jit(lambda x: jnp.sort(x * 3 + 1))
    x = jnp.arange(1000, dtype=jnp.float32)
    out, wall, comp, mem = cs.warm_and_time(lambda: f(x), clock)
    assert comp > 0 and wall >= 0 and out.shape == (1000,)
    assert mem == {}                    # the CPU keeps no allocator stats
    with clock:
        jax.block_until_ready(f(x))
    assert clock.seconds == 0.0


def test_compile_clock_listens_only_inside_its_block():
    import jax
    import jax.numpy as jnp
    from jax._src import monitoring
    before = len(monitoring.get_event_duration_listeners())
    clocks = [cs.CompileClock() for _ in range(3)]
    assert len(monitoring.get_event_duration_listeners()) == before
    with clocks[0]:
        assert len(monitoring.get_event_duration_listeners()) == before + 1
        jax.block_until_ready(jax.jit(lambda x: x * 5 - 2)(jnp.ones(7)))
    assert len(monitoring.get_event_duration_listeners()) == before
    assert clocks[0].seconds > 0 and clocks[1].seconds == 0.0


class _FakeAllocator:
    """memory_stats() stand-in: bytes_in_use walks through `trace`."""

    def __init__(self, peak0, trace):
        self.peak, self.trace, self.i = peak0, trace, 0

    def __call__(self):
        cur = self.trace[min(self.i, len(self.trace) - 1)]
        self.i += 1
        self.peak = max(self.peak, cur)
        return {"bytes_in_use": cur, "peak_bytes_in_use": self.peak}


def _watch(monkeypatch, alloc, work_s=0.05):
    import time
    monkeypatch.setattr(cs, "_memory_stats", alloc)
    with cs.PhaseMemory() as mem:
        time.sleep(work_s)
        mem.stop_sampling()
    return mem.fields


def test_phase_memory_exact_when_the_phase_raises_the_peak(monkeypatch):
    fields = _watch(monkeypatch, _FakeAllocator(100, [10, 500, 20]))
    assert fields == {"bytes_in_use_before": 10, "bytes_in_use_after": 20,
                      "phase_peak_bytes": 500, "phase_peak_exact": True}


def test_phase_memory_samples_below_an_earlier_peak(monkeypatch):
    # an earlier phase left the process peak at 1000: this phase's 300 is
    # seen only by the sampler, and reported as a lower bound
    fields = _watch(monkeypatch, _FakeAllocator(1000, [10, 300, 20]))
    assert fields["phase_peak_exact"] is False
    assert fields["phase_peak_bytes"] == 300
    assert fields["bytes_in_use_after"] == 20


def test_sort_lowering_counts():
    import jax
    import jax.numpy as jnp
    txt = jax.jit(jnp.sort).lower(
        jnp.arange(8, dtype=jnp.uint32)).compile().as_text()
    assert cs.sort_lowering(txt) == {"cub_calls": 0, "xla_sort_ops": 1}
    cub = 'custom-call(x), custom_call_target="__cub$DeviceRadixSort"'
    assert cs.sort_lowering(cub) == {"cub_calls": 1, "xla_sort_ops": 0}


# --- refusal without a GPU -------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_cpu(argv, capsys):
    assert cs.main(argv) == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] is False
    assert last["device"]["platform"] == "cpu"


def test_script_alone_fails(tmp_path):
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert json.loads(r.stdout.strip().splitlines()[-1])["ok"] is False
