"""Batch-dim partitioning wrapper for the relax kernel.

The hybrid sharded solver (parallel/hybrid.py) runs each pyramid level
on row-stacked tile batches under ordinary GSPMD partitioning.  A
``pallas_call`` is a custom call that the partitioner cannot split, so
the relax kernel runs inside a minimal manual region: a shard_map whose
body is exactly one ``relax_phase_batched`` call, partitioned over the
leading batch (= tile) dimension.  Per-device batch counts stay integral
(the tiled solver always passes multiples of the mesh size).  The
solver's replicated coarse levels use the same region with every
operand replicated, so no kernel is ever left to the partitioner.
"""

from __future__ import annotations

from jax import shard_map
from jax.sharding import PartitionSpec as P

from panorama_opticalflow_tpu.ops.pallas import relax
from panorama_opticalflow_tpu.utils.config import FlowParams


class PartitionedKernels:
    """Namespace with ``relax.relax_phase_batched``'s signature whose
    call runs in its own one-kernel shard_map over the leading batch
    dim.  Passed as the ``knd`` argument of the level core
    (models.pixflow) by the hybrid sharded solver."""

    def __init__(self, mesh, axis: str | None):
        """``axis``: the mesh axis the batch dim is split over; None
        runs the whole batch on every device (replicated operands)."""
        self.mesh = mesh
        self.axis = axis

    def relax_phase_batched(self, flow, f_base, w1g, i0x, i0y, blurred_flow,
                            update_mask, params: FlowParams, iters: int,
                            D: int):
        def fn(*a):
            return relax.relax_phase_batched(*a, params, iters, D)

        spec = P(self.axis) if self.axis else P()
        return shard_map(fn, mesh=self.mesh, in_specs=(spec,) * 7,
                         out_specs=spec, check_vma=False)(
            flow, f_base, w1g, i0x, i0y, blurred_flow, update_mask)
