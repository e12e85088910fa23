"""Golden-file dump utilities.

Byte-compatible with the reference's cfg(morton_code_readback) artifact dump
(/root/reference/src/main.rs:751-766): `morton_codes.txt` holds one decimal
u64 morton code per line; `indices.txt` holds one `(x, y, z)` triangle per
line. Used for cross-checking the device pipeline against the reference
algorithm and for regression goldens.
"""

from __future__ import annotations

import os

import numpy as np


def dump_morton_codes(codes: np.ndarray, path: str = "morton_codes.txt") -> str:
    codes = np.asarray(codes, dtype=np.uint64)
    with open(path, "w") as f:
        for v in codes:
            f.write(f"{int(v)}\n")
    return os.path.abspath(path)


def dump_indices(tris: np.ndarray, path: str = "indices.txt") -> str:
    tris = np.asarray(tris).reshape(-1, 3)
    with open(path, "w") as f:
        for x, y, z in tris:
            f.write(f"({int(x)}, {int(y)}, {int(z)})\n")
    return os.path.abspath(path)


def load_morton_codes(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([int(line) for line in f if line.strip()],
                        dtype=np.uint64)


def load_indices(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip().strip("()")
            if line:
                rows.append([int(t) for t in line.split(",")])
    return np.asarray(rows, dtype=np.uint32)
