"""Global constants of the PyTorch port (a copy of ``neus2_tpu/constants.py``:
the port imports nothing of the JAX package, so it keeps its own).

These mirror the behavior contract of the reference implementation
(reference: src/testbed_nerf.cu:55-81, include/neural-graphics-primitives/nerf.h:24)
but are plain Python constants here — everything is runtime-configurable where the
reference used compile-time #defines.
"""

import math

# Ray marching ------------------------------------------------------------
# Finest number of steps per unit length (reference NERF_STEPS()).
NERF_STEPS = 1024
SQRT3 = math.sqrt(3.0)
# Base step size for ray marching (reference STEPSIZE()).
STEPSIZE = SQRT3 / NERF_STEPS
MIN_CONE_STEPSIZE = STEPSIZE

# Occupancy grid ----------------------------------------------------------
# Grid resolution per cascade (reference NERF_GRIDSIZE(), nerf.h:24).
NERF_GRIDSIZE = 128
# Maximum number of cascades (reference NERF_CASCADES()).
NERF_CASCADES = 8
# Maximum step size is the width of the coarsest grid cell.
MAX_CONE_STEPSIZE = STEPSIZE * (1 << (NERF_CASCADES - 1)) * NERF_STEPS / NERF_GRIDSIZE
# Occupancy threshold: any density below this is culled
# (reference NERF_MIN_OPTICAL_THICKNESS(), testbed_nerf.cu:75: 0.1 for NeuS).
NERF_MIN_OPTICAL_THICKNESS = 0.1
# Fallback per-update density decay (merge_probes default).  The production
# path (engine/train.py occupancy_update:632) instead calibrates the decay
# to the permutation-sweep period — 0.5 ** (1/updates_per_full_sweep) — so
# no cell is forgotten faster than the sweep re-measures it; see
# engine/occupancy.py's module docstring for the measured failure modes of
# fixed rates (reference's own rate is 0.95/step backed by ~1M probes/step).
DENSITY_GRID_DECAY = 0.95

# Rendering ---------------------------------------------------------------
NERF_RENDERING_NEAR_DISTANCE = 0.2
# Max ray-march iterations at render time (reference MARCH_ITER).
MARCH_ITER = 10000

# Training ----------------------------------------------------------------
# Default samples per training batch (reference m_training_batch_size = 1<<18).
DEFAULT_BATCH_SIZE = 1 << 18
# Transmittance early-out threshold in the training composite
# (reference compute_loss_kernel EPSILON = 1e-4).
TRAIN_TRANSMITTANCE_EPS = 1e-4
# SDF bias added to the raw SDF-MLP output (reference nerf_network.h:87).
SDF_BIAS = -0.1
# Initial value of the single variance parameter (reference nerf_network.h:86,
# initialize_params: generate_random_uniform(..., 0.300f, 0.300f)).
VARIANCE_INIT = 0.3
