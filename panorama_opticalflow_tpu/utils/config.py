"""Configuration dataclasses for the pixflow solver and stitch pipeline.

Parity notes: hyperparameter presets mirror the reference factory
``makeOpticalFlowByName`` (CPU/PixFlow.hpp:459-500) and the solver constants
(CPU/PixFlow.hpp:32-44).  Everything here is a static (hashable) pytree-free
config so it can be passed as a jit static argument.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FlowParams:
    """Hyperparameters of the pixflow dense optical-flow solver.

    Mirrors CPU/PixFlow.hpp:32-68.  ``max_percentage`` selects the
    brute-force initial search (0 = zero-init "pixflow_low",
    20 = "pixflow_search_20", CPU/PixFlow.hpp:153-270).
    """

    # Factory presets (CPU/PixFlow.hpp:461-496)
    pyr_scale_factor: float = 0.9
    smoothness_coef: float = 0.001
    vertical_regularization_coef: float = 0.01
    horizontal_regularization_coef: float = 0.01
    gradient_step_size: float = 0.5
    downscale_factor: float = 0.5
    max_percentage: int = 0

    # Solver constants (CPU/PixFlow.hpp:32-44)
    pyr_min_image_size: int = 24
    pyr_max_levels: int = 1000
    # Pyramid floor override (framework extension): stop the
    # pyramid when either side would drop to <= this instead of
    # pyr_min_image_size (0 = use pyr_min_image_size, the reference
    # rule).  The sub-0.1 MP tail levels cost a fixed per-level
    # overhead regardless of area (on the GPU: not measured yet)
    # while carrying almost no alignment information at production
    # canvas scales; the _fast presets raise the floor to 64 px
    # (SSIM-gated against the reference binary like every _fast
    # deviation).  pyr_min_image_size itself stays untouched because
    # search_distance derives from it (reference semantics).
    pyr_stop_size: int = 0
    grad_epsilon: float = 0.001
    update_alpha_threshold: float = 0.9
    median_blur_size: int = 5
    pre_blur_kernel_width: int = 5
    pre_blur_sigma: float = 0.25
    final_flow_blur_kernel_width: int = 3
    final_flow_blur_sigma: float = 1.0
    gradient_blur_kernel_width: int = 3
    gradient_blur_sigma: float = 0.5
    blurred_flow_kernel_width: int = 15
    blurred_flow_sigma: float = 8.0

    # Parallel relaxation schedule.  The reference CPU build runs two
    # sequential raster sweeps per pyramid level (CPU/PixFlow.hpp:315-337);
    # its own CUDA build replaces them with 10 rounds of a data-parallel
    # 4-neighbour relaxation kernel (GPU/PixFlow_GPU.cu:274-290), proving the
    # algorithm tolerates parallel (Jacobi) propagation.  We run
    # ``relax_phases`` phases of ``relax_iters_per_phase`` Jacobi iterations,
    # with a 5x5 median filter after each phase (the CPU build medians after
    # each sweep, CPU/PixFlow.hpp:325,338).
    # Measured fidelity knob (tools-assisted sweeps, rounds 1-2): vs the
    # sequential oracle, 2 phases x 5 iters scores EPE 0.115/0.049 on
    # the synthetic gates; 2 x 3 scores 0.116/0.056 at 40% less relax
    # work; 2 x 2 scores EPE 0.126 vs 0.127 for 2 x 3 on the round-2
    # gates with the reference-binary golden SSIM unchanged (0.9988).
    # The single-phase default mirrors the reference's own GPU schedule
    # -- 10 relax rounds, then ONE median, then diffusion per level
    # (GPU/PixFlow_GPU.cu:273-295), vs the CPU build's median after each
    # of 2 sweeps -- and halves the per-level warp+median work.  Sweep
    # (tools/sweep_schedule.py): 1x3 scores oracle EPE 0.7208 vs 0.7302
    # for 2x2 on the shifted-pair gate, reference-binary golden SSIM
    # unchanged at 0.9988 (1x4/1x2 also hold: 0.7203/0.7183).
    relax_phases: int = 1
    relax_iters_per_phase: int = 3
    # The coarsest level starts from zero (or search) init, where the
    # sequential sweeps' Gauss-Seidel cascade is worth O(width) descent
    # steps; Jacobi needs a higher count to match.  The level is tiny
    # (<= ~24x30 px) so this is nearly free.
    coarsest_relax_phases: int = 4
    coarsest_relax_iters_per_phase: int = 15

    # Relaxation implementation: "fast" uses the gather-free
    # warp-recentred hat-window path (ops/relax_fast.py) on every level
    # except the coarsest (which starts from zero/search init and is tiny
    # enough for the exact path); "exact" uses per-candidate bilinear
    # gathers everywhere (reference-faithful, used by oracle tests).
    relax_impl: str = "fast"
    # Hat-window half-width of the bounded-residual sampling.  Per-phase
    # warp recentring keeps |flow - f_base| subpixel on real inputs, so
    # D=2 is bit-identical to D=3 on every fidelity gate (round-2
    # measurement) while cutting the relax kernel's separable passes by
    # (2D+1): 7 -> 5 taps (~29% of its compute).
    fast_window: int = 2
    # Reuse the accepted propagation candidate's sample (tracked through
    # pass A) as the descent residual instead of re-sampling at the
    # accepted flow -- removes one of the three y-passes in pass B
    # (~8% of the relax kernel).  The two differ only when the winning
    # neighbour's recentring base f_base differs from the pixel's own
    # (first-order in f_base smoothness, same class as the recentring
    # approximation itself); fidelity is covered by the EPE/SSIM gates.
    fold_descent_sample: bool = True
    # Rung-scanned coarse pyramid tail (models/pixflow._run_rungs): group
    # consecutive coarse levels (area <= scan_max_pixels, never the
    # finest or the coarsest level) into rungs of scan_rung_levels that
    # share the padded shape of the rung's finest member, and lax.scan
    # over them.  The level body -- ~5k XLA ops -- is then traced and
    # compiled ONCE per rung instead of once per level, cutting the jit
    # graph (and the compile time) by ~3-4x.  Runtime cost is the padded
    # work on a rung's coarser members (~1.33x on ~12% of the flow work
    # at default settings) plus per-level resize matmuls.  Numerics
    # deviate from the unrolled
    # path only in blur/median borders at scanned levels' bottom/right
    # edges (gated by the scan-vs-unrolled and oracle EPE/SSIM tests).
    scan_coarse_levels: bool = True
    scan_max_pixels: int = 448 * 1024
    scan_rung_levels: int = 4
    scan_min_levels: int = 3
    # Additionally pair the *fine* unrolled levels (area > scan_max_pixels,
    # never the finest level) into scanned rungs of this many levels --
    # the remaining compile-time lever for very large canvases: each pair
    # roughly halves that span's XLA graph at ~+10% of its runtime work
    # (the coarser member computes at the finer member's padded shape,
    # 1/0.81 area).  1 = off (default: the fine levels dominate runtime,
    # so they stay exact-shaped unless compile time forces pairing).
    scan_fine_rung_levels: int = 1

    @property
    def search_distance(self) -> int:
        # CPU/PixFlow.hpp:153-155
        return (self.pyr_min_image_size * self.max_percentage + 50) // 100


def flow_params_by_name(name: str) -> FlowParams:
    """Flow-algorithm factory, parity with CPU/PixFlow.hpp:459-500.

    ``pixflow_low`` / ``pixflow_search_20`` mirror the reference presets
    exactly.  ``pixflow_low_fast`` / ``pixflow_search_20_fast`` are
    framework extensions: a 0.8-factor pyramid (~20 levels instead of
    ~42), a 64 px pyramid floor with a reference-floor init solve
    (pyr_stop_size + the init-floor refine, models/pixflow), and a
    single coarsest-init relax phase (1x15 Jacobi iters, vs the
    reference GPU's own 10 rounds/level), used with StitchConfig's
    half-resolution blend field.  Output was SSIM-gated against the
    reference binary at 2250x1000 and 9000x4000 (0.9991 / 0.9992)."""
    base, sep, mod = name.partition("+")
    if base == "pixflow_low":
        p = FlowParams(max_percentage=0)
    elif base == "pixflow_search_20":
        p = FlowParams(max_percentage=20)
    elif base == "pixflow_low_fast":
        p = FlowParams(max_percentage=0, pyr_scale_factor=0.8,
                       pyr_stop_size=64, coarsest_relax_phases=1)
    elif base == "pixflow_search_20_fast":
        p = FlowParams(max_percentage=20, pyr_scale_factor=0.8,
                       pyr_stop_size=64, coarsest_relax_phases=1)
    else:
        raise ValueError(f"unrecognized flow algorithm name: {name}")
    if sep:
        # compile-time modifier: "<preset>+pairK" pairs the fine unrolled
        # pyramid levels into K-level scan rungs (see scan_fine_rung_levels);
        # "<preset>+stopN" overrides the pyramid floor (pyr_stop_size)
        if mod.startswith("pair") and mod[4:].isdigit():
            p = dataclasses.replace(p, scan_fine_rung_levels=int(mod[4:]))
        elif mod.startswith("stop") and mod[4:].isdigit():
            p = dataclasses.replace(p, pyr_stop_size=int(mod[4:]))
        elif mod.startswith("cph") and mod[3:].isdigit():
            # coarsest-init relax phases (fast-preset experiments)
            p = dataclasses.replace(p, coarsest_relax_phases=int(mod[3:]))
        else:
            raise ValueError(f"unrecognized flow algorithm modifier: {mod}")
    return p


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    """End-to-end stitch pipeline configuration.

    Wrap-extension fractions mirror the reference: the flow inputs are
    extended by cols/20 on each side (CPU/OpticalFlow.cpp:113-126) and the
    blend map by cols/5 (CPU/StitchTool.cpp:102-111); both are manual
    periodic halos on the equirectangular (x-wrapping) canvas.
    """

    flow_alg: str = "pixflow_low"
    # Denominators of the wrap-extension widths (cols // N).
    flow_extend_div: int = 20
    blend_extend_div: int = 5
    # Blend-field constants (CPU/StitchTool.cpp:130-143,148-158)
    blend_step_div: int = 200          # ray stride = min(rows, cols)//200
    blend_smooth_kernel_div: int = 130  # selective box blur = rows//130
    blend_global_blur_div: int = 400    # final global box blur = rows//400
    # Gather hole-search radius (CPU/StitchTool.cpp:77)
    gather_search_radius: int = 100
    # Blend-field resolution divisor (framework extension).  The
    # blend weights are a smooth field by construction -- ray-distance
    # ratios followed by a rows/130 selective blur and a rows/400
    # global blur (CPU/StitchTool.cpp:127-143) -- so computing the
    # field on an s-decimated canvas map and bilinearly upsampling the
    # result is visually lossless while cutting the stage cost ~s^2.
    # 0 = auto: 2 for the `_fast` presets
    # (SSIM-gated extensions), 1 (reference-exact field) otherwise.
    blend_scale: int = 0

    @property
    def blend_scale_resolved(self) -> int:
        if self.blend_scale:
            return self.blend_scale
        return 2 if "_fast" in self.flow_alg else 1

    @property
    def flow_params(self) -> FlowParams:
        return flow_params_by_name(self.flow_alg)
