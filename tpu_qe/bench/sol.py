"""Peak memory bandwidth per device kind, and bytes-over-peak bounds.

The least time a memory-bound operation can take is the bytes it must move
divided by the device's peak memory bandwidth. The reference publishes no
numbers (SURVEY.md §6), so this bound is the yardstick.

Bytes-moved model for one LSD radix pass over n elements:
  read keys (8B) + payload (4B per u32 column)
  write keys (8B) + payload
  (histogram traffic is O(radix * num_blocks) — negligible at real sizes)

A fused single-kernel pass therefore moves 2 * (8 + 4*p) bytes per element;
a split histogram+scatter pipeline (like the reference's, which reads keys
in both kernels) adds one more key read.

A device kind missing from the table is an error, never a default. On the
CPU backend there is no device bound: the functions return None ("not
measured").
"""

from __future__ import annotations

import jax

# Peak device-memory bandwidth in bytes/s, keyed by jax's device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 80 GB HBM3:
# 3.35 TB/s; PCIe 80 GB HBM2e: 2.0 TB/s).
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # H100 SXM5
    "NVIDIA H100 PCIe": 2.0e12,         # H100 PCIe
}


def device_kind() -> str:
    return jax.devices()[0].device_kind


def hbm_peak_bytes_per_s(device=None) -> float | None:
    """Peak memory bandwidth of `device` (default: the first device);
    None on the CPU backend; KeyError for a kind the table lacks."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return None
    try:
        return HBM_PEAK[device.device_kind]
    except KeyError:
        raise KeyError(
            f"no peak bandwidth for device kind {device.device_kind!r}: "
            "add it to tpu_qe.bench.sol.HBM_PEAK with its source") from None


def sort_pass_bytes(n: int, payload_cols: int = 1, key_bytes: int = 8,
                    fused: bool = True) -> int:
    per_elem = key_bytes + 4 * payload_cols
    reads = per_elem if fused else per_elem + key_bytes
    return n * (reads + per_elem)


def sort_sol_seconds(n: int, num_passes: int, payload_cols: int = 1,
                     key_bytes: int = 8, fused: bool = True
                     ) -> float | None:
    peak = hbm_peak_bytes_per_s()
    if peak is None:
        return None
    return num_passes * sort_pass_bytes(n, payload_cols, key_bytes,
                                        fused) / peak


def elementwise_seconds(n: int, num_operands: int = 1) -> float | None:
    """One streaming read + write of num_operands u32 planes."""
    peak = hbm_peak_bytes_per_s()
    return None if peak is None else 2.0 * n * 4 * num_operands / peak
