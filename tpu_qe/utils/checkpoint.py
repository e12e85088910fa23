"""Table checkpoint/restore (orbax-backed).

The reference persists nothing beyond cfg-gated text dumps
(/root/reference/src/main.rs:751-766 — covered by tpu_qe.utils.dump); a
production engine needs durable columnar state, so Tables serialize through
orbax (JAX's checkpointing library) with dtype-exact round-trips,
including u64 columns (stored as their (lo, hi) u32 planes).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from tpu_qe.bits import U64
from tpu_qe.table import Table


def _flatten(table: Table) -> dict:
    out = {}
    for name in table:
        if name.endswith("@lo") or name.endswith("@hi"):
            raise ValueError(
                f"column name {name!r} collides with the u64 plane "
                "encoding (reserved suffixes '@lo'/'@hi')")
        c = table[name]
        if isinstance(c, U64):
            out[f"{name}@lo"] = c.lo
            out[f"{name}@hi"] = c.hi
        else:
            out[name] = c
    return out


def _unflatten(tree: dict) -> Table:
    cols = {}
    for k, v in tree.items():
        if k.endswith("@lo"):
            cols[k[:-3]] = U64(jnp.asarray(v),
                               jnp.asarray(tree[k[:-3] + "@hi"]))
        elif k.endswith("@hi"):
            continue
        else:
            cols[k] = jnp.asarray(v)
    return Table(cols)


def save_table(table: Table, path: str) -> str:
    """Write a Table checkpoint to `path` (a directory). Returns the path."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(path, _flatten(table), force=True)
    ckpt.wait_until_finished()
    return path


def load_table(path: str) -> Table:
    """Restore a Table checkpoint written by save_table."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckpt = ocp.StandardCheckpointer()
    tree = ckpt.restore(path)
    return _unflatten(tree)


def save_table_npz(table: Table, path: str) -> str:
    """Dependency-light alternative: single-file .npz checkpoint."""
    np.savez(path, **{k: np.asarray(v) for k, v in _flatten(table).items()})
    return os.path.abspath(path)


def load_table_npz(path: str) -> Table:
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


class RunState:
    """Checkpoint/resume state for an out-of-core sort run.

    The resident runs themselves are NOT persisted — they are 12 GB of
    device memory, and they are REGENERABLE: phase A is
    a deterministic function of (n, run_size, seed). What a restart
    cannot re-derive cheaply-and-identically is (a) the splitter plan
    (bucket boundaries must match or completed buckets mean nothing) and
    (b) which buckets already merged + their verification scalars. Both
    are tiny and are persisted atomically (tmp + rename) after the plan
    and after every bucket readback, so a kill at any point resumes with
    identical output: phase A regenerates, phase B loads, completed
    buckets skip straight to their recorded scalars.
    """

    N_SCALARS = 9  # s_ok, h_ok, cnt, psum, psq, flo, fhi, llo, lhi

    def __init__(self, path: str, meta: np.ndarray, bounds: np.ndarray,
                 done: np.ndarray, scalars: np.ndarray):
        self.path = path
        self.meta = meta
        self.bounds = bounds
        self.done = done
        self.scalars = scalars

    @classmethod
    def fresh(cls, directory: str, meta: np.ndarray, bounds: np.ndarray,
              n_buckets: int, n_scalars: int | None = None) -> "RunState":
        st = cls(cls._path(directory), meta, bounds,
                 np.zeros(n_buckets, np.int64),
                 np.zeros((n_buckets, n_scalars or cls.N_SCALARS),
                          np.int64))
        st.save()
        return st

    @staticmethod
    def _path(directory: str) -> str:
        return os.path.join(directory, "bigsort_state.npz")

    @classmethod
    def load(cls, directory: str, meta: np.ndarray) -> "RunState | None":
        """Load a matching checkpoint; None if absent or for another run
        configuration (a mismatched plan must never be reused)."""
        p = cls._path(directory)
        if not os.path.exists(p):
            return None
        with np.load(p) as z:
            if not np.array_equal(z["meta"], meta):
                return None
            return cls(p, meta, z["bounds"], z["done"], z["scalars"])

    def save(self) -> None:
        tmp = self.path + ".tmp.npz"  # np.savez appends .npz otherwise
        np.savez(tmp, meta=self.meta, bounds=self.bounds, done=self.done,
                 scalars=self.scalars)
        os.replace(tmp, self.path)

    def record(self, b: int, vals) -> None:
        self.scalars[b] = [int(v) for v in vals]
        self.done[b] = 1
        self.save()
