"""Hand-written kernels for the solver hot path (SURVEY.md section 7,
layer 4).

The reference's speed-of-light layer is BLASFEO's cache-tiled small-matrix
kernels inside HPIPM's Riccati recursion (SURVEY.md N2/N3).  Here the
equivalent is not a faster 8x8 factorization — it is removing the per-step
launch overhead of the 100-stage sequential sweep by running the entire
backward+forward Riccati recursion for a group of lanes in ONE Pallas
(Triton) program whose working set lives in registers.
"""

from mpc_collisionavoidance_tpu.kernels.riccati_pallas import (  # noqa: F401
    lqr_solve_lanes_pallas)
