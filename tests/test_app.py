"""App-shell tests: config, golden dumps, profiling counters, CLI verify run.

Runs on the CPU backend (tests/conftest.py selects it, with a virtual
8-device mesh), mirroring the reference's test strategy of CPU
oracles + end-to-end verdicts (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np
import pytest

from tpu_qe import native
from tpu_qe.config import EngineConfig, SceneConfig, SortConfig
from tpu_qe.utils.dump import (dump_indices, dump_morton_codes, load_indices,
                               load_morton_codes)


def test_sort_config_validation():
    SortConfig()  # defaults valid
    with pytest.raises(ValueError):
        SortConfig(bits_per_pass=0)
    with pytest.raises(ValueError):
        SortConfig(bits_per_pass=16, num_passes=8)  # 128 bits > 64+pad
    assert SortConfig(bits_per_pass=6, num_passes=11).key_bits == 64


def test_scene_config_validation():
    with pytest.raises(ValueError):
        SceneConfig(num_vertices=0)


def test_engine_config_from_env(monkeypatch):
    monkeypatch.setenv("TPU_QE_NUM_PASSES", "4")
    monkeypatch.setenv("TPU_QE_SEED", "11")
    cfg = EngineConfig.from_env()
    assert cfg.sort.num_passes == 4
    assert cfg.scene.seed == 11


def test_dump_round_trip(tmp_path):
    codes = np.array([0, 1, 2**63 + 5, 2**64 - 1], dtype=np.uint64)
    tris = np.array([[1, 2, 3], [4, 5, 6]], dtype=np.uint32)
    p1 = dump_morton_codes(codes, str(tmp_path / "codes.txt"))
    p2 = dump_indices(tris, str(tmp_path / "idx.txt"))
    assert np.array_equal(load_morton_codes(p1), codes)
    assert np.array_equal(load_indices(p2), tris)
    # format parity with the reference dump (main.rs:751-766)
    lines = open(p2).read().splitlines()
    assert lines[0] == "(1, 2, 3)"


def test_dump_matches_native_pipeline(tmp_path):
    verts, tris, smin, smax = native.scene_generate(100, 300, 7)
    gen = native.MortonGen(smin, smax)
    codes = gen.encode(verts, tris)
    p = dump_morton_codes(codes, str(tmp_path / "codes.txt"))
    assert np.array_equal(load_morton_codes(p), codes)


def test_cli_verify_pass(capsys):
    from tpu_qe.__main__ import main
    rc = main(["verify", "--vertices", "100", "--triangles", "300"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "VERIFY PASS" in out


def test_cli_dump(tmp_path, capsys):
    from tpu_qe.__main__ import main
    rc = main(["dump", "--vertices", "50", "--triangles", "120",
               "--codes-path", str(tmp_path / "c.txt"),
               "--indices-path", str(tmp_path / "i.txt")])
    assert rc == 0
    assert load_morton_codes(str(tmp_path / "c.txt")).shape == (120,)
    assert load_indices(str(tmp_path / "i.txt")).shape == (120, 3)


def test_cli_info(capsys):
    from tpu_qe.__main__ import main
    assert main(["info"]) == 0
    assert "device_kind" in capsys.readouterr().out


def test_cli_verify_xla_backend(capsys):
    # The verify path with the stable general-payload backend.
    from tpu_qe.__main__ import main
    rc = main(["verify", "--vertices", "64", "--triangles", "200",
               "--backend", "xla"])
    assert rc == 0
    assert "VERIFY PASS" in capsys.readouterr().out


def test_bench_matrix_smoke(capsys):
    # Tiny CPU-backend run of every matrix config (machinery, not perf).
    from tpu_qe.bench import matrix
    matrix.main(["--scale", "0.0001"])
    out = capsys.readouterr().out.strip().splitlines()
    import json
    rows = [json.loads(line) for line in out]
    # 6 configs + the unfused join_agg companion row + the round-5
    # centered-frame/RANGE window companion row
    assert len(rows) == 8
    assert all(r["value"] > 0 for r in rows)


def test_table_pytree_map_safe():
    # regression: tree_unflatten ran the validating __init__, so any
    # jax.tree.map over a Table with scalar/placeholder leaves crashed
    import jax
    t = Table_for_pytree()
    sums = jax.tree.map(lambda x: x.sum(), t)
    assert set(sums._cols) == {"k", "v"}
    ones = jax.tree.map(lambda x: 1.0, t)
    assert ones._cols["v"] == 1.0


def Table_for_pytree():
    from tpu_qe.table import Table
    return Table.from_numpy({
        "k": np.arange(4, dtype=np.uint32),
        "v": np.ones(4, dtype=np.float32)})


def test_checkpoint_rejects_reserved_column_names(tmp_path):
    import pytest
    from tpu_qe.table import Table
    from tpu_qe.utils.checkpoint import save_table_npz
    t = Table.from_numpy({"x@hi": np.ones(3, dtype=np.float32)})
    with pytest.raises(ValueError, match="reserved"):
        save_table_npz(t, str(tmp_path / "t.npz"))
