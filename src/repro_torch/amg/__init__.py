from .stencil import diffusion_2d, paper_problem, rotated_anisotropic_stencil
from .coarsen import direct_interpolation, pmis, strength_graph
from .hierarchy import (
    Hierarchy,
    Level,
    build_hierarchy,
    from_reference_hierarchy,
    jacobi,
    solve,
    v_cycle,
)
from .distributed import DistOp, DistributedHierarchy, DistributedLevel
from .distributed_setup import (
    DistributedSetup,
    ExchangeRecord,
    SetupLevel,
    distributed_build_hierarchy,
    partition_fine_matrix,
)

__all__ = [
    "diffusion_2d", "paper_problem", "rotated_anisotropic_stencil",
    "direct_interpolation", "pmis", "strength_graph",
    "Hierarchy", "Level", "build_hierarchy", "from_reference_hierarchy",
    "jacobi", "solve", "v_cycle",
    "DistOp", "DistributedHierarchy", "DistributedLevel",
    "DistributedSetup", "ExchangeRecord", "SetupLevel",
    "distributed_build_hierarchy", "partition_fine_matrix",
]
