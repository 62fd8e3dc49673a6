"""Parity oracles (SURVEY.md section 7, layer 7).

The reference's correctness story is acados itself; ours is layered oracles
that re-solve the SAME OCP through independent machinery:

- `nlp_oracle`: the full nonlinear OCP as a dense scipy SLSQP program with
  exact acados slack semantics — the control-trajectory parity target is
  <1e-3 (BASELINE.md) against the converged SQP solver;
- `kkt`: NLP feasibility/fixed-point reporting for any solver iterate;
- `acados_oracle`: optional true-acados bridge (activates only where
  acados_template is installed; the zero-egress build image does not ship it).
"""

from mpc_collisionavoidance_tpu.parity.kkt import kkt_report  # noqa: F401
from mpc_collisionavoidance_tpu.parity.nlp_oracle import (  # noqa: F401
    solve_ocp_nlp_dense)
