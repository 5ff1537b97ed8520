from .problem import MPCProblem, mpc_cost, rollout_controls
from .solver import MPCSolution, receding_horizon, solve_mpc, solve_mpc_gn

__all__ = [
    "MPCProblem",
    "mpc_cost",
    "rollout_controls",
    "MPCSolution",
    "solve_mpc",
    "solve_mpc_gn",
    "receding_horizon",
]
