from slam_toolbox_tpu_torch.dist.solver_dist import (  # noqa: F401
    distributed_lm_solve, make_distributed_gn_step,
)
