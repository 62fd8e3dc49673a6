"""mpc_collisionavoidance_tpu — accelerator-native nonlinear MPC for ASV path following
and LiDAR-based collision avoidance.

A ground-up JAX / XLA / Pallas re-design of the capabilities of the
ivanacollg/MPC_CollisionAvoidance reference stack (acados SQP-RTI + HPIPM +
CasADi codegen + ROS C++ nodes), built accelerator-first:

- dynamics are pure JAX functions; sensitivities come from `jax.jacfwd`
  through an RK4 shooting step (replacing CasADi-generated VDE C code),
- the OCP quadratic subproblem is solved by a stage-wise primal-dual
  interior-point method whose Newton systems are factorized with a Riccati
  sweep expressed as `lax.scan` (replacing HPIPM's Riccati IPM),
- scale comes from `jax.vmap` over scenario batches on one chip and
  `shard_map` over a `jax.sharding.Mesh` across chips/hosts (replacing the
  one-solve-per-tick single-core execution model of the reference).

Subpackages
-----------
models    : the 13 OCP model variants (dynamics, bounds, constraints)
ocp       : problem specification (costs, bounds, soft constraints)
ops       : integrators, linearization, Riccati, interior-point primitives
solver    : batched SQP-RTI orchestration + warm-start state
guidance  : waypoint manager, obstacle intake, command extraction
sim       : closed-loop scenario engine + scenario library
parallel  : mesh construction and sharded batch solves
utils     : angles, plotting, profiling
parity    : oracles (dense QP / scipy NLP / optional acados) for validation
"""

__version__ = "0.1.0"

from mpc_collisionavoidance_tpu.models import registry as model_registry  # noqa: F401
