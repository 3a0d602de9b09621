"""360-degree panorama optical-flow stitching framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
MungoMeng/Panorama-OpticalFlow second-stage pipeline: pyramidal
coarse-to-fine "pixflow" dense optical flow, asymmetric bidirectional
flow-guided novel-view synthesis with softmax deghosting, distance-field
seam blending, and iterative (6-input fisheye) or single-pass (4-input
wide-angle) composition onto an equirectangular, x-periodic canvas.

Design stance (array-program first, not a port):
  * the whole per-pair stitch is one jit-compiled, statically-shaped array
    program -- no host round trips inside the pyramid loop;
  * the reference's sequential raster sweeps are expressed as Jacobi-style
    parallel relaxation iterations (the formulation its own CUDA variant
    validates, GPU/PixFlow_GPU.cu:153-296), with a Pallas (Triton) relax
    kernel on the GPU;
  * batching via vmap, multi-device scaling via shard_map tiling of the
    canvas with halo exchange over collectives.
"""

__version__ = "0.1.0"

from panorama_opticalflow_tpu.utils.config import (  # noqa: F401
    FlowParams,
    StitchConfig,
    flow_params_by_name,
)
