"""Runtime configuration.

The reference's configuration is entirely compile-time — problem size, radix
width, pass count, block sizes, seed in /root/reference/src/constants.rs:1-21
plus rustc --cfg flags selecting run mode (/root/reference/.cargo/config.toml
:1-2). A query engine needs runtime-varying problem sizes, so this is a real
config system: dataclasses with validation, overridable from the CLI
(python -m tpu_qe) and from env (TPU_QE_*).
"""

from __future__ import annotations

import dataclasses
import os

from tpu_qe import constants


def _env(name: str, default, cast):
    v = os.environ.get(f"TPU_QE_{name}")
    return default if v is None else cast(v)


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """LSD radix sort configuration (reference constants.rs:5-19)."""

    bits_per_pass: int = constants.BITS_PER_PASS
    num_passes: int = constants.NUM_PASSES
    backend: str = "xla"

    def __post_init__(self):
        if not (1 <= self.bits_per_pass <= 16):
            raise ValueError(f"bits_per_pass out of range: {self.bits_per_pass}")
        # Last pass must start inside the 64-bit key (the reference's
        # 6-bit/11-pass test variant covers 66 bits, with the final pass
        # reading the top 4 real bits — tests.rs:116-130).
        if self.bits_per_pass * (self.num_passes - 1) >= 64:
            raise ValueError("pass schedule extends past the 64-bit key")

    @property
    def key_bits(self) -> int:
        return min(self.bits_per_pass * self.num_passes, 64)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Seeded random scene (reference constants.rs:1-3,21 + create_scene)."""

    num_vertices: int = constants.NUM_VERTICES
    num_triangles: int = constants.NUM_TRIANGLES
    seed: int = constants.RNG_SEED

    def __post_init__(self):
        if self.num_vertices <= 0 or self.num_triangles <= 0:
            raise ValueError("scene sizes must be positive")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine config; env overrides via TPU_QE_<FIELD>."""

    sort: SortConfig = dataclasses.field(default_factory=SortConfig)
    scene: SceneConfig = dataclasses.field(default_factory=SceneConfig)
    # Profiling hooks (reference start_capture/stop_capture + debug markers,
    # main.rs:718,729,588-662): directory for jax.profiler traces.
    trace_dir: str | None = None
    verbose: bool = False

    @staticmethod
    def from_env() -> "EngineConfig":
        return EngineConfig(
            sort=SortConfig(
                bits_per_pass=_env("BITS_PER_PASS", constants.BITS_PER_PASS, int),
                num_passes=_env("NUM_PASSES", constants.NUM_PASSES, int),
                backend=_env("BACKEND", "xla", str),
            ),
            scene=SceneConfig(
                num_vertices=_env("NUM_VERTICES", constants.NUM_VERTICES, int),
                num_triangles=_env("NUM_TRIANGLES", constants.NUM_TRIANGLES, int),
                seed=_env("SEED", constants.RNG_SEED, int),
            ),
            trace_dir=_env("TRACE_DIR", None, str),
            verbose=bool(_env("VERBOSE", 0, int)),
        )
