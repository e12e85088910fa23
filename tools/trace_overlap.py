#!/usr/bin/env python
"""Capture XProf traces of the monolithic vs overlapped distributed sort.

The SURVEY §2c exchange/compute-overlap evidence artifact: run
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/trace_overlap.py --trace-dir /tmp/overlap_traces
and open the trace in XProf/TensorBoard: with --overlap k the timeline
shows k independent (all_to_all -> per-chunk sort) pairs whose sorts
interleave with later collectives, versus one barrier-shaped
all_to_all -> sort chain for the monolithic path.

On a host with fewer devices than --n-dev the run stops with an error;
the command above gives the CPU backend eight virtual devices. On GPUs
the same program (same HLO collective structure) runs over NCCL.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--n-dev", type=int, default=8)
    ap.add_argument("--overlap", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_qe.bits import U64
    from tpu_qe.exchange import distributed_sort, make_mesh
    from tpu_qe.utils.profiling import marker, trace_session

    if len(jax.devices()) < args.n_dev:
        raise SystemExit(f"need {args.n_dev} devices, have "
                         f"{len(jax.devices())} ({jax.devices()[0].platform})")
    mesh = make_mesh(args.n_dev)
    sh = NamedSharding(mesh, P("x"))

    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1 << 64, size=args.n, dtype=np.uint64)
    u = U64.from_numpy(keys)
    key = U64(jax.device_put(u.lo, sh), jax.device_put(u.hi, sh))
    payload = jax.device_put(jnp.arange(args.n, dtype=jnp.uint32), sh)

    def run(overlap):
        res, ovf = distributed_sort(key, payload, mesh=mesh,
                                    capacity_factor=3.0, overlap=overlap)
        jax.block_until_ready(res.key.lo)
        assert int(np.asarray(ovf).max()) == 0
        return res

    for overlap in (1, args.overlap):
        run(overlap)  # compile outside the trace
        t0 = time.perf_counter()
        with trace_session(args.trace_dir and
                           f"{args.trace_dir}/overlap{overlap}"):
            with marker(f"dsort_overlap{overlap}"):
                run(overlap)
        dt = time.perf_counter() - t0
        print(f"overlap={overlap}: {args.n} keys on {args.n_dev} devices "
              f"in {dt * 1e3:.1f} ms ({args.n / dt / 1e6:.1f} M keys/s)")


if __name__ == "__main__":
    main()
