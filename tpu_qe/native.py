"""ctypes bindings for the tpu_qe native core (tpu_qe/cpp/core.cc).

The native library holds the host-side compute the reference implements in
Rust (scene generation, morton LUT construction, CPU oracles — cf.
/root/reference/src/main.rs:114-233,923-1028). It is built on demand with
`make` the first time it is loaded, into a path keyed by the source and the
host's architecture, so a library built elsewhere is never reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_CPP_DIR = os.path.join(os.path.dirname(__file__), "cpp")

_lock = threading.Lock()
_lib = None

# Flattened morton-uniform sizes, matching the reference GPU layout
# (/root/reference/src/main.rs:183,189).
LUT_U32_LEN = 4608
SIZE_LUT_U32_LEN = 8192
# Morton bit layout: single source of truth is tpu_qe/constants.py
# (mirrored by tpu_qe/cpp/core.cc).
from tpu_qe.constants import (COORD_BITS, SIZE_BITS,  # noqa: E402,F401
                              SIZE_INDEX_BITS)


def lib_path(cpp_dir: str = _CPP_DIR, machine: str | None = None) -> str:
    """Where the library built from this source on this architecture lives:
    build/libqecore-<hash of core.cc, Makefile and machine>.so."""
    h = hashlib.sha256((machine or platform.machine()).encode())
    for name in ("core.cc", "Makefile"):
        with open(os.path.join(cpp_dir, name), "rb") as f:
            h.update(f.read())
    return os.path.join(cpp_dir, "build",
                        f"libqecore-{h.hexdigest()[:16]}.so")


def build(cpp_dir: str = _CPP_DIR) -> str:
    """Build the library unless this source's build exists; returns its
    path. Builds to a private name and renames, so concurrent processes
    never load a half-written file."""
    path = lib_path(cpp_dir)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["make", "-s", f"OUT={tmp}"], cwd=cpp_dir,
                       check=True)
        os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u64, u32, f32p, u32p, u64p = (
            ctypes.c_uint64,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64),
        )
        u8p = ctypes.POINTER(ctypes.c_uint8)
        voidp = ctypes.c_void_p
        lib.tq_chacha8_fill_u32.argtypes = [u64, u64, u32p]
        lib.tq_chacha8_fill_f32.argtypes = [u64, u64, f32p]
        lib.tq_chacha8_raw_block.argtypes = [u8p, u64, u32p]
        lib.tq_scene_generate.argtypes = [u32, u32, u64, f32p, u32p, f32p, f32p]
        lib.tq_morton_gen_sizeof.restype = u64
        lib.tq_morton_gen_init.argtypes = [f32p, f32p, voidp]
        lib.tq_morton_gen_flatten.argtypes = [voidp, u32p, u32p, f32p]
        lib.tq_morton_quantize.argtypes = [voidp, f32p, u32p, u64, u32p]
        lib.tq_morton_encode.argtypes = [voidp, f32p, u32p, u64, u64p]
        lib.tq_morton_encode_quirk.argtypes = [voidp, f32p, u32p, u64, u64p]
        lib.tq_morton_encode_direct.argtypes = [u32p, u64, u64p]
        lib.tq_select_digit8.argtypes = [u32, u32, u32]
        lib.tq_select_digit8.restype = u32
        lib.tq_select_digit6.argtypes = [u32, u32, u32]
        lib.tq_select_digit6.restype = u32
        lib.tq_lsd_sort.argtypes = [u64p, u32p, u64, u32, u32]
        lib.tq_digit_major_histogram.argtypes = [u64p, u64, u32, u32, u32, u32p]
        lib.tq_block_rank.argtypes = [u32p, u64, u32, u32p]
        lib.tq_scatter_locations.argtypes = [u64p, u64, u32, u32, u32, u64p]
        lib.tq_pipeline_oracle.argtypes = [u32, u32, u64, u64p, u32p]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def chacha8_u32(seed: int, n: int) -> np.ndarray:
    """Raw ChaCha8Rng u32 stream (rand_chacha-compatible, seed_from_u64)."""
    lib = _load()
    out = np.empty(n, dtype=np.uint32)
    lib.tq_chacha8_fill_u32(seed, n, _ptr(out, ctypes.c_uint32))
    return out


def chacha8_f32(seed: int, n: int) -> np.ndarray:
    lib = _load()
    out = np.empty(n, dtype=np.float32)
    lib.tq_chacha8_fill_f32(seed, n, _ptr(out, ctypes.c_float))
    return out


def chacha8_raw_block(key32: bytes, counter: int) -> np.ndarray:
    lib = _load()
    key = np.frombuffer(key32, dtype=np.uint8).copy()
    out = np.empty(16, dtype=np.uint32)
    lib.tq_chacha8_raw_block(_ptr(key, ctypes.c_uint8), counter,
                             _ptr(out, ctypes.c_uint32))
    return out


def scene_generate(num_vertices: int, num_triangles: int, seed: int):
    """Seeded random scene (reference create_scene, main.rs:114-173).

    Returns (vertices (V,3) f32, triangles (T,3) u32, scene_min, scene_max).
    """
    if num_vertices <= 0 or num_triangles < 0:
        raise ValueError(
            f"need num_vertices >= 1 (got {num_vertices}) and "
            f"num_triangles >= 0 (got {num_triangles})")
    lib = _load()
    verts = np.empty((num_vertices, 3), dtype=np.float32)
    tris = np.empty((num_triangles, 3), dtype=np.uint32)
    smin = np.empty(3, dtype=np.float32)
    smax = np.empty(3, dtype=np.float32)
    lib.tq_scene_generate(
        num_vertices, num_triangles, seed,
        _ptr(verts, ctypes.c_float), _ptr(tris, ctypes.c_uint32),
        _ptr(smin, ctypes.c_float), _ptr(smax, ctypes.c_float))
    return verts, tris, smin, smax


class MortonGen:
    """Extended-morton LUT generator (native); mirrors the observable surface
    of the reference's `extended_morton_coder` crate usage
    (/root/reference/src/main.rs:175-198)."""

    def __init__(self, scene_min: np.ndarray, scene_max: np.ndarray):
        lib = _load()
        self._buf = np.zeros(int(lib.tq_morton_gen_sizeof()), dtype=np.uint8)
        smin = np.ascontiguousarray(scene_min, dtype=np.float32)
        smax = np.ascontiguousarray(scene_max, dtype=np.float32)
        lib.tq_morton_gen_init(
            _ptr(smin, ctypes.c_float), _ptr(smax, ctypes.c_float),
            self._buf.ctypes.data_as(ctypes.c_void_p))
        lut = np.empty(LUT_U32_LEN, dtype=np.uint32)
        size_lut = np.empty(SIZE_LUT_U32_LEN, dtype=np.uint32)
        scalars = np.empty(8, dtype=np.float32)
        lib.tq_morton_gen_flatten(
            self._buf.ctypes.data_as(ctypes.c_void_p),
            _ptr(lut, ctypes.c_uint32), _ptr(size_lut, ctypes.c_uint32),
            _ptr(scalars, ctypes.c_float))
        # GPU-layout uniforms (reference main.rs:177-198 / types.rs:46-54)
        self.lut_flat = lut                    # 4608 u32 = 9*256 * (lo,hi)
        self.size_lut_flat = size_lut          # 8192 u32 = 4096 * (lo,hi)
        self.morton_index_scale = float(scalars[0])
        self.offset = scalars[1:4].copy()
        self.size_multiplier = float(scalars[4])
        self.multiplier = scalars[5:8].copy()
        # u64 views for convenience
        self.lut = lut.view(np.uint64).reshape(9, 256)
        self.size_lut = size_lut.view(np.uint64)

    def quantize(self, verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
        lib = _load()
        tris = np.ascontiguousarray(tris, dtype=np.uint32)
        verts = np.ascontiguousarray(verts, dtype=np.float32)
        n = tris.shape[0]
        q = np.empty((n, 4), dtype=np.uint32)
        lib.tq_morton_quantize(
            self._buf.ctypes.data_as(ctypes.c_void_p),
            _ptr(verts, ctypes.c_float), _ptr(tris, ctypes.c_uint32), n,
            _ptr(q, ctypes.c_uint32))
        return q

    def encode(self, verts: np.ndarray, tris: np.ndarray,
               quirk: bool = False) -> np.ndarray:
        """Morton codes for a triangle scene.

        quirk=True reproduces the SHIPPED reference kernel's LUT
        consumption (morton_code.wgsl:72-74: the i*3 byte shift) instead
        of the resolved i*8 layout — see core.cc encode_one_lut_quirk.
        """
        lib = _load()
        tris = np.ascontiguousarray(tris, dtype=np.uint32)
        verts = np.ascontiguousarray(verts, dtype=np.float32)
        n = tris.shape[0]
        codes = np.empty(n, dtype=np.uint64)
        fn = lib.tq_morton_encode_quirk if quirk else lib.tq_morton_encode
        fn(self._buf.ctypes.data_as(ctypes.c_void_p),
           _ptr(verts, ctypes.c_float), _ptr(tris, ctypes.c_uint32), n,
           _ptr(codes, ctypes.c_uint64))
        return codes


def morton_encode_direct(q: np.ndarray) -> np.ndarray:
    """LUT-free bit-interleave encoding of quantized (qx,qy,qz,j) rows."""
    lib = _load()
    q = np.ascontiguousarray(q, dtype=np.uint32)
    n = q.shape[0]
    codes = np.empty(n, dtype=np.uint64)
    lib.tq_morton_encode_direct(_ptr(q, ctypes.c_uint32), n,
                                _ptr(codes, ctypes.c_uint64))
    return codes


def select_digit8(pass_number: int, lo: int, hi: int) -> int:
    return int(_load().tq_select_digit8(pass_number, lo, hi))


def select_digit6(pass_number: int, lo: int, hi: int) -> int:
    return int(_load().tq_select_digit6(pass_number, lo, hi))


def lsd_sort(keys: np.ndarray, payload: np.ndarray | None = None,
             bits_per_pass: int = 8, num_passes: int = 8):
    """Stable LSD radix sort oracle (in C++). Returns sorted copies."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64).copy()
    n = keys.shape[0]
    if payload is not None:
        payload = np.ascontiguousarray(payload, dtype=np.uint32).copy()
        pp = _ptr(payload, ctypes.c_uint32)
    else:
        pp = ctypes.POINTER(ctypes.c_uint32)()
    lib.tq_lsd_sort(_ptr(keys, ctypes.c_uint64), pp, n, bits_per_pass,
                    num_passes)
    return (keys, payload) if payload is not None else keys


def digit_major_histogram(keys: np.ndarray, pass_number: int,
                          bits_per_pass: int, block_size: int) -> np.ndarray:
    """Digit-major (radix, num_blocks) histogram — layout of the reference
    histogram kernel (radix_sort_histogram.wgsl:58-59)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = keys.shape[0]
    radix = 1 << bits_per_pass
    nb = -(-n // block_size)
    hist = np.empty(radix * nb, dtype=np.uint32)
    lib.tq_digit_major_histogram(_ptr(keys, ctypes.c_uint64), n, pass_number,
                                 bits_per_pass, block_size,
                                 _ptr(hist, ctypes.c_uint32))
    return hist.reshape(radix, nb)


def block_rank(digits: np.ndarray, radix: int) -> np.ndarray:
    lib = _load()
    digits = np.ascontiguousarray(digits, dtype=np.uint32)
    out = np.empty_like(digits)
    lib.tq_block_rank(_ptr(digits, ctypes.c_uint32), digits.shape[0], radix,
                      _ptr(out, ctypes.c_uint32))
    return out


def scatter_locations(keys: np.ndarray, pass_number: int, bits_per_pass: int,
                      block_size: int) -> np.ndarray:
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = keys.shape[0]
    out = np.empty(n, dtype=np.uint64)
    lib.tq_scatter_locations(_ptr(keys, ctypes.c_uint64), n, pass_number,
                             bits_per_pass, block_size,
                             _ptr(out, ctypes.c_uint64))
    return out


def pipeline_oracle(num_vertices: int, num_triangles: int, seed: int):
    """End-to-end CPU oracle: scene -> morton -> stable (code, index) sort."""
    lib = _load()
    codes = np.empty(num_triangles, dtype=np.uint64)
    idx = np.empty(num_triangles, dtype=np.uint32)
    lib.tq_pipeline_oracle(num_vertices, num_triangles, seed,
                           _ptr(codes, ctypes.c_uint64),
                           _ptr(idx, ctypes.c_uint32))
    return codes, idx
