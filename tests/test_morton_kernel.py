"""Morton encoding paths (points, quirk-mode LUT) vs the native builder."""

from __future__ import annotations

import numpy as np

from tpu_qe import morton, native


def _params(seed=7):
    verts, tris, smin, smax = native.scene_generate(200, 600, seed)
    return morton.MortonParams.for_scene(smin, smax), verts, tris


def test_encode_points_matches_degenerate_triangles():
    """A point == a degenerate triangle (all three vertices equal, size 0)."""
    import jax.numpy as jnp

    params, _, _ = _params(seed=3)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32) * 50
    # degenerate triangles: each references one vertex three times
    tris = np.repeat(np.arange(500, dtype=np.int32)[:, None], 3, axis=1)
    want = morton.encode(jnp.asarray(pts), jnp.asarray(tris), params)
    got = morton.encode_points(jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]),
                               jnp.asarray(pts[:, 2]), params)
    np.testing.assert_array_equal(np.asarray(got.lo), np.asarray(want.lo))
    np.testing.assert_array_equal(np.asarray(got.hi), np.asarray(want.hi))


class TestQuirkLutMode:
    """Quirk-faithful consumption of the shipped reference kernel
    (morton_code.wgsl:72-74: i*3 byte shift where the LUT layout implies
    i*8). Given identical LUT content, the C++ oracle and the XLA LUT path
    must agree byte-exactly in quirk mode."""

    def _scene(self, n_tris=3000):
        from tpu_qe import native
        verts, tris, smin, smax = native.scene_generate(1000, n_tris, 7)
        gen = native.MortonGen(smin, smax)
        return verts, tris, gen

    def test_cpp_quirk_vs_xla_quirk(self):
        import jax.numpy as jnp
        import numpy as np
        from tpu_qe import morton
        verts, tris, gen = self._scene()
        want = gen.encode(verts, tris, quirk=True)
        params = morton.MortonParams.from_native(gen)
        got = morton.encode(jnp.asarray(verts),
                            jnp.asarray(tris.astype(np.int32)), params,
                            quirk_lut=True)
        np.testing.assert_array_equal(got.to_numpy(), want)

    def test_quirk_differs_from_resolved(self):
        import numpy as np
        verts, tris, gen = self._scene()
        a = gen.encode(verts, tris, quirk=False)
        b = gen.encode(verts, tris, quirk=True)
        assert not np.array_equal(a, b)  # the quirk is observable

    def test_dump_quirk_byte_match(self, tmp_path):
        # `dump --quirk-lut` must byte-match the quirk-mode C++ oracle
        import numpy as np
        from tpu_qe.__main__ import main
        from tpu_qe.utils.dump import dump_morton_codes
        verts, tris, gen = self._scene(256)
        codes = gen.encode(verts, tris, quirk=True)
        want_path = tmp_path / "want.txt"
        dump_morton_codes(codes, str(want_path))
        got_path = tmp_path / "got.txt"
        rc = main(["dump", "--vertices", "1000", "--triangles", "256",
                   "--seed", "7", "--quirk-lut",
                   "--codes-path", str(got_path),
                   "--indices-path", str(tmp_path / "idx.txt")])
        assert rc == 0
        assert got_path.read_bytes() == want_path.read_bytes()
