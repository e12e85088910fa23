"""Sort driver tests against the C++ oracle.

Test strategy per SURVEY.md §4: scalar oracles plus end-to-end
bit-exactness on seeded random data, over sizes straddling power-of-two
boundaries.
"""

import numpy as np
import pytest

from tpu_qe import native
from tpu_qe.bits import U64
from tpu_qe.sort import sort_u64_numpy


def _rand_keys(n, seed=0, bits=64):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=n, dtype=np.uint64)


class TestSortDrivers:
    @pytest.mark.parametrize("backend", ["xla", "xla_tiebreak"])
    @pytest.mark.parametrize("n", [1, 255, 256, 1023, 1024, 1025, 3000, 20000])
    def test_full_u64_sort_bit_exact(self, backend, n):
        keys = _rand_keys(n, seed=n)
        payload = np.arange(n, dtype=np.uint32)
        k, p = sort_u64_numpy(keys, payload, backend=backend)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(k, keys[order])
        np.testing.assert_array_equal(p, order.astype(np.uint32))

    @pytest.mark.parametrize("backend", ["xla", "xla_tiebreak"])
    def test_matches_cpp_oracle(self, backend):
        keys = _rand_keys(3000, seed=7)
        payload = np.arange(3000, dtype=np.uint32)
        ok, op = native.lsd_sort(keys, payload)
        k, p = sort_u64_numpy(keys, payload, backend=backend)
        np.testing.assert_array_equal(k, ok)
        np.testing.assert_array_equal(p, op)

    @pytest.mark.parametrize("backend", ["xla", "xla_tiebreak"])
    def test_partial_key_bits_stable(self, backend):
        # Sorting by the low 16 bits only: equal-digit elements keep input
        # order (stability), and only masked bits are ordered — semantics of
        # the reference's select_bits verification (main.rs:1042-1051).
        keys = _rand_keys(5000, seed=3)
        payload = np.arange(5000, dtype=np.uint32)
        k, p = sort_u64_numpy(keys, payload, backend=backend, key_bits=16)
        masked = k & np.uint64(0xFFFF)
        assert (np.diff(masked.astype(np.int64)) >= 0).all()
        order = np.argsort(keys & np.uint64(0xFFFF), kind="stable")
        np.testing.assert_array_equal(p, order.astype(np.uint32))
        np.testing.assert_array_equal(k, keys[order])

    @pytest.mark.parametrize("backend", ["xla", "xla_tiebreak"])
    def test_duplicate_heavy_keys(self, backend):
        rng = np.random.default_rng(11)
        keys = rng.integers(0, 4, size=4000, dtype=np.uint64)
        payload = np.arange(4000, dtype=np.uint32)
        k, p = sort_u64_numpy(keys, payload, backend=backend)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(p, order.astype(np.uint32))

    def test_multiple_payload_columns(self):
        import jax.numpy as jnp
        from tpu_qe.sort import sort_u64
        keys = _rand_keys(2000, seed=2)
        p1 = np.arange(2000, dtype=np.uint32)
        p2 = (np.arange(2000, dtype=np.uint32) * 7) % 2000
        k, (s1, s2) = sort_u64(U64.from_numpy(keys), jnp.asarray(p1),
                               jnp.asarray(p2), backend="xla_tiebreak")
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(np.asarray(s1), p1[order])
        np.testing.assert_array_equal(np.asarray(s2), p2[order])


class TestMortonJax:
    def test_quantize_and_encode_match_native(self):
        import jax.numpy as jnp
        from tpu_qe import morton
        v, t, smin, smax = native.scene_generate(1000, 3000, 7)
        gen = native.MortonGen(smin, smax)
        params = morton.MortonParams.from_native(gen)
        qj = gen.quantize(v, t)
        q, j = morton.quantize(jnp.asarray(v), jnp.asarray(t.astype(np.int32)),
                               params)
        np.testing.assert_array_equal(np.asarray(q), qj[:, :3])
        np.testing.assert_array_equal(np.asarray(j), qj[:, 3])
        code = morton.encode_quantized(q, j)
        np.testing.assert_array_equal(
            U64(*code).to_numpy(), gen.encode(v, t))

    def test_lut_path_matches_direct(self):
        import jax.numpy as jnp
        from tpu_qe import morton
        v, t, smin, smax = native.scene_generate(500, 2000, 3)
        params = morton.MortonParams.for_scene(smin, smax)
        tj = jnp.asarray(t.astype(np.int32))
        direct = morton.encode(jnp.asarray(v), tj, params, use_lut=False)
        lut = morton.encode(jnp.asarray(v), tj, params, use_lut=True)
        np.testing.assert_array_equal(U64(*direct).to_numpy(),
                                      U64(*lut).to_numpy())

    def test_end_to_end_pipeline_matches_oracle(self):
        # scene -> morton -> sort on device vs tq_pipeline_oracle
        import jax.numpy as jnp
        from tpu_qe import morton
        from tpu_qe.sort import sort_u64
        v, t, smin, smax = native.scene_generate(1000, 3000, 7)
        params = morton.MortonParams.for_scene(smin, smax)
        code = morton.encode(jnp.asarray(v), jnp.asarray(t.astype(np.int32)),
                             params)
        idx = jnp.arange(3000, dtype=jnp.uint32)
        sk, (sp,) = sort_u64(code, idx, backend="xla_tiebreak")
        ocodes, oidx = native.pipeline_oracle(1000, 3000, 7)
        np.testing.assert_array_equal(U64(*sk).to_numpy(), ocodes)
        np.testing.assert_array_equal(np.asarray(sp), oidx)


class TestTiebreakBackend:
    @pytest.mark.parametrize("n", [1, 255, 1024, 3000])
    def test_equals_stable_with_unique_payload(self, n):
        rng = np.random.default_rng(n)
        # heavy duplicates so the tiebreak actually decides order
        keys = rng.integers(0, 16, n).astype(np.uint64) * np.uint64(977)
        payload = np.arange(n, dtype=np.uint32)
        k1, p1 = sort_u64_numpy(keys, payload, backend="xla")
        k2, p2 = sort_u64_numpy(keys, payload, backend="xla_tiebreak")
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(p1, p2)

    def test_masked_key_bits_variant(self):
        rng = np.random.default_rng(9)
        keys = rng.integers(0, 1 << 64, 2000, dtype=np.uint64)
        payload = np.arange(2000, dtype=np.uint32)
        k1, p1 = sort_u64_numpy(keys, payload, backend="xla", key_bits=24)
        k2, p2 = sort_u64_numpy(keys, payload, backend="xla_tiebreak",
                                key_bits=24)
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(p1, p2)


class TestBitExactUnderJit:
    """What keeps the morton keys bit-exact with the C++ oracle inside one
    fused XLA program, on any backend."""

    def test_jitted_pipeline_matches_oracle(self):
        # one jitted program: XLA fuses quantize, so an FMA contraction or
        # an inexact sqrt would move cells at quantization boundaries
        import jax.numpy as jnp
        from tpu_qe import morton, pipeline
        v, t, smin, smax = native.scene_generate(1 << 14, 1 << 15, 7)
        params = morton.MortonParams.for_scene(smin, smax)
        res = pipeline.sorted_morton_index(
            jnp.asarray(v), jnp.asarray(t.astype(np.int32)), params)
        ocodes, oidx = native.pipeline_oracle(1 << 14, 1 << 15, 7)
        np.testing.assert_array_equal(res.code.to_numpy(), ocodes)
        np.testing.assert_array_equal(np.asarray(res.order), oidx)

    @pytest.mark.parametrize("ulps", [-2, -1, 0, 1, 2])
    def test_round_sqrt_corrects_estimates(self, ulps):
        # an estimate within two ulps (a GPU's sqrt) rounds to sqrtf
        import jax.numpy as jnp
        from tpu_qe.morton import round_sqrt
        rng = np.random.default_rng(ulps + 10)
        x = np.concatenate([
            rng.random(1 << 15).astype(np.float32) * 1e4,
            np.exp2(rng.uniform(-100, 100, 1 << 15)).astype(np.float32),
            np.float32([0.0, 1.0, 2.0, 1e-40, np.inf])])
        want = np.sqrt(x)
        normal = (x >= np.finfo(np.float32).tiny) & np.isfinite(x)
        est = np.where(normal, want.view(np.uint32).astype(np.int64) + ulps,
                       want.view(np.uint32)).astype(np.uint32)
        got = np.asarray(round_sqrt(jnp.asarray(x),
                                    jnp.asarray(est.view(np.float32))))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
