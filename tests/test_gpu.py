"""Checks that need a GPU: the main path at a modest size, with x64 on
(the suite's setting; chip_smoke.py's phases A-C run with it off).

Each test skips without a GPU. chip_smoke.py runs them on the card, in
its own process (``pytest -m gpu tests/test_gpu.py``).
"""

import numpy as np
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


@pytest.fixture
def clock():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (chip_smoke.py runs these on the card)")
    return cs.CompileClock()


def test_morton_sort_bit_exact(clock):
    (line,) = cs.phase_sort(20, clock)
    assert line["ok"], line


def test_sql_queries_match_numpy(clock):
    lines = cs.phase_sql(18, 12, clock)
    assert all(line["ok"] for line in lines), lines


def test_bigsql_closed_form(clock):
    (line,) = cs.phase_bigsql(22, 8, 20, clock)
    assert line["ok"], line


@pytest.mark.parametrize("backend", ["xla", "xla_tiebreak"])
def test_sort_u64_matches_stable_numpy(clock, backend):
    from tpu_qe.sort import sort_u64_numpy
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 64, 1 << 20, dtype=np.uint64)
    keys[::5] = keys[1]
    idx = np.arange(len(keys), dtype=np.uint32)
    k, p = sort_u64_numpy(keys, idx, backend=backend)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(k, keys[order])
    assert np.array_equal(p, order.astype(np.uint32))
