"""cilqr_tpu — uncertainty-aware CILQR trajectory optimization in JAX.

A ground-up JAX/XLA/Pallas framework with the capabilities of the C++/ROS/
CUDA reference stack (see SURVEY.md / docs/ARCHITECTURE.md).  Entry points:

  SolverParams / CostmapParams / NoiseParams   configuration pytrees
  models.solver.run_step(_jit)                 one planning cycle (faithful)
  models.solver_batched.run_steps_batched      batched solve (XLA / GPU kernel)
  ops.costmap.build_local_costmap              uncertainty costmap tick
  sim.plant.closed_loop / sim.runner           CARLA-free closed loop
  parallel.batch / parallel.monte_carlo        vmap + shard_map scaling
"""

from cilqr_tpu.utils.params import (  # noqa: F401
    CostmapParams,
    NoiseParams,
    SolverParams,
    DEFAULT_COSTMAP,
    DEFAULT_NOISE,
    DEFAULT_PARAMS,
)

__version__ = "0.1.0"

__all__ = [
    "CostmapParams",
    "NoiseParams",
    "SolverParams",
    "DEFAULT_COSTMAP",
    "DEFAULT_NOISE",
    "DEFAULT_PARAMS",
    "__version__",
]
