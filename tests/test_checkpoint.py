"""Table checkpoint round-trips (orbax + npz) and 1M-key oracle parity."""

from __future__ import annotations

import numpy as np
import pytest

from tpu_qe import native
from tpu_qe.table import Table


def _table(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return Table.from_numpy({
        "key": rng.integers(0, 1 << 64, n, dtype=np.uint64),
        "v32": rng.integers(0, 1 << 31, n, dtype=np.uint32),
        "f": rng.standard_normal(n).astype(np.float32),
    })


def _assert_tables_equal(a: Table, b: Table):
    an, bn = a.to_numpy(), b.to_numpy()
    assert set(an) == set(bn)
    for k in an:
        np.testing.assert_array_equal(an[k], bn[k])


def test_npz_round_trip(tmp_path):
    from tpu_qe.utils.checkpoint import load_table_npz, save_table_npz
    t = _table()
    p = save_table_npz(t, str(tmp_path / "t.npz"))
    _assert_tables_equal(t, load_table_npz(p))


def test_orbax_round_trip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from tpu_qe.utils.checkpoint import load_table, save_table
    t = _table(seed=3)
    p = save_table(t, str(tmp_path / "ckpt"))
    _assert_tables_equal(t, load_table(p))


def test_sort_1m_keys_bit_exact_vs_cpp_oracle():
    """BASELINE config #1: 1M keys, sorted stream bit-exact vs the oracle."""
    from tpu_qe.sort import sort_u64_numpy

    rng = np.random.default_rng(42)
    keys = rng.integers(0, 1 << 64, 1 << 20, dtype=np.uint64)
    payload = np.arange(1 << 20, dtype=np.uint32)
    got_k, got_p = sort_u64_numpy(keys, payload)
    want_k, want_p = native.lsd_sort(keys, payload)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_p, want_p)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_sort_backends_vs_oracle(seed):
    """Differential fuzz: random sizes/dup-rates, both backends vs C++."""
    from tpu_qe.sort import sort_u64_numpy

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    dup_bits = int(rng.integers(2, 64))
    keys = (rng.integers(0, 1 << 63, n, dtype=np.uint64)
            & ((np.uint64(1) << np.uint64(dup_bits)) - np.uint64(1)))
    payload = np.arange(n, dtype=np.uint32)
    want_k, want_p = native.lsd_sort(keys, payload)
    for backend in ("xla", "xla_tiebreak"):
        got_k, got_p = sort_u64_numpy(keys, payload, backend=backend)
        np.testing.assert_array_equal(got_k, want_k, err_msg=backend)
        np.testing.assert_array_equal(got_p, want_p, err_msg=backend)


def test_table_save_load_methods(tmp_path):
    import numpy as np
    from tpu_qe.table import Table
    rng = np.random.default_rng(1)
    t = Table.from_numpy({
        "key": rng.integers(0, 1 << 64, 128, dtype=np.uint64),
        "v": rng.random(128).astype(np.float32),
    })
    p = t.save(str(tmp_path / "t.npz"))
    back = Table.load(p)
    want = t.to_numpy()
    got = back.to_numpy()
    np.testing.assert_array_equal(got["key"], want["key"])
    np.testing.assert_array_equal(got["v"], want["v"])
