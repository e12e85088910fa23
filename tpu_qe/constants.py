"""Engine constants.

Mirrors the reference's compile-time configuration
(reference src/constants.rs:1-21) where a constant still has meaning
here. Unlike the reference, runtime problem sizes are configurable
(tpu_qe.config.SortConfig); these are the defaults.
"""

# Reference-parity scene defaults (constants.rs:1-3,21)
NUM_VERTICES = 1000
NUM_TRIANGLES = 3000
RNG_SEED = 7

# Radix configuration (constants.rs:5-7,19)
BITS_PER_PASS = 8
NUM_PASSES = 8                      # 8 x 8 bits = full 64-bit key

# Morton code layout (tpu_qe/cpp/core.cc)
COORD_BITS = 20
SIZE_BITS = 4
SIZE_INDEX_BITS = 12
