"""The paper's distributed conv and matmul on explicit process grids, per
rank over ``torch.distributed``, with their backward passes, the
grid-parallel CNN train step (``dist.train``) and LM serving on the
matmul grid (``dist.lm``) -- the port of ``repro/dist``.

Grid tuple conventions:

* conv:   ``(Pb, Ph, Pw, Pk, Pc)`` over mesh axes ``("b","h","w","k","c")``
* matmul: ``(Pm, Pn, Pc)``         over mesh axes ``("m","n","c")``

Schedules (``allgather`` / ``ring`` / ``ring2``) move the same wire and
differ in peak memory and in how the transfers are pipelined (see
``dist.conv2d``).  Both ops are differentiable two ways: by default a
``torch.autograd.Function`` whose backward replays the forward gathers
and transposes the communication (communication-optimal memory); with
``save_gathered=True`` autograd differentiates the forward schedule
through the collectives' own transposes, keeping the gathered operands
and paying zero gather-replay wire (the memory-for-wire endpoint).
``*_comm_elems`` / ``*_train_comm_elems`` and ``*_mem_elems`` /
``*_train_mem_elems`` give the analytic per-rank wire and peak-live
memory of both endpoints, and ``repro_torch.core.sharding_synthesis``
picks a grid by them.

``dist.lm`` routes every projection of a transformer decode step through
``matmul_distributed`` (``dist_projection``) and the MoE expert FFN with
the experts on the contraction ring (``expert_ffn_distributed``);
``lm_serve_comm_elems`` / ``lm_serve_mem_elems`` account a serving step
and ``core.sharding_synthesis.synthesize_serve_grid`` picks its grid.

``dist.pipeline.pipelined_apply`` runs stages of a network as a GPipe
microbatch pipeline over one mesh axis (differentiable by the reverse
ring), and ``dist.compress.compressed_psum(_tree)`` mean-reduces
gradients over an axis through an int8 / top-k compressor with error
feedback, moving int8 on the wire below 8 ranks.  ``dist.train`` also
holds the fault-tolerant loop around the grid train step
(``make_resilient_train_loop``).
"""

from repro_torch.dist.collectives import (
    SCHEDULES,
    CollectiveNote,
    gather_axis,
    make_mesh,
    record_collectives,
    ring_all_gather,
    ring_reduce,
    ring_reduce_scatter,
    ring_scatter_reduce,
    ring_zip,
    scatter_axis,
)
from repro_torch.dist.compress import compressed_psum, compressed_psum_tree
from repro_torch.dist.conv2d import (
    conv2d_distributed,
    conv_comm_elems,
    conv_grid_divides,
    conv_mem_elems,
    conv_ring2_supported,
    conv_train_comm_elems,
    conv_train_mem_elems,
    make_conv_mesh,
)
from repro_torch.dist.halo import halo_accumulate_1d, halo_exchange_1d
from repro_torch.dist.lm import (
    dist_projection,
    expert_ffn_distributed,
    kv_cache_elems,
    lm_decode_matmuls,
    lm_serve_comm_elems,
    lm_serve_mem_elems,
    moe_ffn_comm_elems,
    moe_ffn_grid_divides,
    projection_routed,
)
from repro_torch.dist.matmul import (
    make_matmul_mesh,
    matmul_comm_elems,
    matmul_distributed,
    matmul_grid_divides,
    matmul_mem_elems,
    matmul_mesh_from_conv,
    matmul_ring2_supported,
    matmul_train_comm_elems,
    matmul_train_mem_elems,
)
from repro_torch.dist.pipeline import pipelined_apply

# dist.train sits above the model/optimizer stack (it imports models.cnn,
# which imports the dist ops); re-export it lazily so importing the
# primitives package neither pulls in the training stack nor risks a
# circular import.
_TRAIN_EXPORTS = ("make_grid_train_step", "init_grid_train_state",
                  "cnn_train_comm_elems", "cnn_train_mem_elems",
                  "grid_divides_cnn", "ResilienceConfig",
                  "make_resilient_train_loop", "make_synthetic_cnn_batches")


def __getattr__(name):
    if name in _TRAIN_EXPORTS:
        from repro_torch.dist import train as _train
        return getattr(_train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "SCHEDULES", "CollectiveNote", "record_collectives",
    "gather_axis", "ring_all_gather",
    "ring_reduce", "ring_reduce_scatter", "ring_scatter_reduce",
    "ring_zip", "scatter_axis", "make_mesh",
    "conv2d_distributed", "make_conv_mesh", "conv_comm_elems",
    "conv_train_comm_elems", "conv_grid_divides", "conv_mem_elems",
    "conv_train_mem_elems", "conv_ring2_supported",
    "matmul_distributed", "make_matmul_mesh", "matmul_comm_elems",
    "matmul_train_comm_elems", "matmul_grid_divides", "matmul_mem_elems",
    "matmul_train_mem_elems", "matmul_ring2_supported",
    "matmul_mesh_from_conv",
    "halo_exchange_1d", "halo_accumulate_1d",
    "pipelined_apply", "compressed_psum", "compressed_psum_tree",
    "dist_projection", "projection_routed", "expert_ffn_distributed",
    "moe_ffn_grid_divides", "moe_ffn_comm_elems", "lm_decode_matmuls",
    "lm_serve_comm_elems", "lm_serve_mem_elems", "kv_cache_elems",
    "make_grid_train_step", "init_grid_train_state",
    "cnn_train_comm_elems", "cnn_train_mem_elems", "grid_divides_cnn",
    "ResilienceConfig", "make_resilient_train_loop",
    "make_synthetic_cnn_batches",
]
