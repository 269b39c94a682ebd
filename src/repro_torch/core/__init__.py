"""Paper core: two-level tile optimization + distributed-algorithm
synthesis -- the port of ``repro/core`` (pure Python; the port keeps its
own copy).

Li, Xu, Sukumaran-Rajam, Rountev, Sadayappan — "Efficient Distributed
Algorithms for Convolutional Neural Networks", SPAA '21.
"""

from repro_torch.core.cost_model import (
    TileChoice,
    cost_distributed_bwd,
    cost_distributed_comm,
    cost_distributed_init,
    cost_distributed_total,
    cost_distributed_train,
    cost_global_memory,
    cost_global_memory_exact,
    cost_sequential,
    cost_simplified,
    memory_distributed,
    memory_distributed_train,
    ml_from_m,
    simulate_tiled_movement,
    tile_footprint,
)
from repro_torch.core.grid import (
    CommVolume,
    ProcessorGrid,
    comm_volume,
    compare_algorithms,
    grid_from_tuple,
    synthesize,
)
from repro_torch.core.problem import ConvProblem, resnet50_layers
from repro_torch.core.sharding_synthesis import (
    DistGridChoice,
    LayerSharding,
    ServeGridChoice,
    synthesize_dist_grid,
    synthesize_layer,
    synthesize_model,
    synthesize_serve_grid,
)
from repro_torch.core.tile_optimizer import (
    ALGO_25D,
    ALGO_2D,
    ALGO_3D,
    Solution,
    brute_force,
    solve,
    solve_closed_form,
    table1_cost,
    table2_cost,
)

__all__ = [
    "ConvProblem", "resnet50_layers", "TileChoice", "Solution",
    "ProcessorGrid", "CommVolume", "LayerSharding",
    "cost_sequential", "cost_global_memory", "cost_global_memory_exact",
    "cost_simplified", "cost_distributed_init", "cost_distributed_comm",
    "cost_distributed_total", "cost_distributed_bwd",
    "cost_distributed_train", "memory_distributed",
    "memory_distributed_train", "ml_from_m",
    "tile_footprint", "simulate_tiled_movement",
    "solve", "solve_closed_form", "brute_force", "table1_cost", "table2_cost",
    "synthesize", "comm_volume", "compare_algorithms", "grid_from_tuple",
    "synthesize_layer", "synthesize_model",
    "DistGridChoice", "synthesize_dist_grid",
    "ServeGridChoice", "synthesize_serve_grid",
    "ALGO_2D", "ALGO_25D", "ALGO_3D",
]
