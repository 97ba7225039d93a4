# The sharded-frontier (owner-computes halo) engine of the port
# (counterpart of repro.dist.engine_sharded's halo rounds).
from repro_torch.dist.engine_sharded import (
    HALO_DTYPES,
    FrontierPlan,
    frontier_ef_init,
    frontier_kernel_round_ext_fn,
    frontier_round_ext_fn,
    make_frontier_plan,
    resolve_halo_dtype,
)

__all__ = [
    "HALO_DTYPES",
    "FrontierPlan",
    "frontier_ef_init",
    "frontier_kernel_round_ext_fn",
    "frontier_round_ext_fn",
    "make_frontier_plan",
    "resolve_halo_dtype",
]
