"""Utility-layer tests: visualizers, metrics, runtime timers."""

import numpy as np

from panorama_opticalflow_tpu.utils import metrics, runtime, visualize


def test_ssim_basics(rng):
    img = rng.integers(0, 256, (40, 50, 3), np.uint8)
    assert metrics.ssim(img, img) == 1.0
    noisy = np.clip(img.astype(int)
                    + rng.integers(-40, 40, img.shape), 0, 255).astype(np.uint8)
    s = metrics.ssim(img, noisy)
    assert 0.0 < s < 1.0
    assert metrics.endpoint_error(np.zeros((4, 4, 2)),
                                  np.ones((4, 4, 2))) == np.sqrt(2)


def test_visualizers(rng):
    flow = rng.normal(0, 3, (40, 60, 2)).astype(np.float32)
    img = rng.integers(0, 256, (40, 60, 4), np.uint8)

    grey = visualize.flow_as_grey_disparity(flow)
    assert grey.shape == (40, 60) and grey.dtype == np.uint8
    assert grey.min() == 0 and grey.max() == 255

    wheel = visualize.flow_color_wheel(flow)
    assert wheel.shape == (40, 60, 3) and wheel.dtype == np.uint8

    field = visualize.flow_as_vector_field(flow, img)
    assert field.shape == (40, 60, 3)

    stacked = visualize.stack_horizontal([wheel, wheel])
    assert stacked.shape == (40, 120, 3)


def test_stage_timer(caplog):
    import logging

    t = runtime.StageTimer()
    with caplog.at_level(logging.INFO, logger="panostitch"):
        with t.stage("Part1"):
            pass
        total = t.total()
    assert total >= 0
    assert t.stages[0][0] == "Part1"
    assert any("Part1" in r.message for r in caplog.records)


def test_init_runtime_idempotent():
    runtime.init_runtime(verbose=False, compilation_cache=False)
    runtime.init_runtime(verbose=False, compilation_cache=False)


def test_cache_dir_defaults_to_repo(monkeypatch):
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert runtime.compilation_cache_dir() == os.path.join(repo, ".cache",
                                                           "xla")


def test_cache_dir_left_to_jax_when_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no cache
    directory of its own."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compilation_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    runtime.init_runtime(verbose=False)
    assert jax.config.jax_compilation_cache_dir == before


def test_time_call_blocks_and_counts(monkeypatch):
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    assert runtime.time_call(fn, 1, iters=3) >= 0.0
    assert len(calls) == 4        # one warm-up call, three timed


def test_stage_timer_profiler_trace(tmp_path, monkeypatch):
    """PANOSTITCH_TRACE_DIR (CLI --profile_dir) wraps each stage in a
    jax.profiler trace; the trace directory must be produced with
    TensorBoard/XProf event data inside (SURVEY section 5 tracing)."""
    import os

    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("PANOSTITCH_TRACE_DIR", str(tmp_path))
    t = runtime.StageTimer()
    with t.stage("TraceMe"):
        jnp.square(jnp.arange(16.0)).block_until_ready()
    stage_dir = tmp_path / "TraceMe"
    assert stage_dir.is_dir()
    files = [os.path.join(r, f) for r, _, fs in os.walk(stage_dir)
             for f in fs]
    assert files, "profiler produced no trace files"


def test_flow_visualizers_behaviour():
    """Behavioural checks of the three visualisers
    (CPU/OpticalFlow.cpp:147-204 semantics)."""
    import numpy as np
    from panorama_opticalflow_tpu.utils import visualize as vz

    h, w = 48, 72
    flow = np.zeros((h, w, 2), np.float32)
    flow[:, : w // 2, 0] = -5.0   # left half moves left, right half still

    grey = vz.flow_as_grey_disparity(flow)
    assert grey.shape == (h, w) and grey.dtype == np.uint8
    # min displacement (-5) maps to 0, max (0) maps to 255
    assert grey[0, 0] == 0 and grey[0, -1] == 255

    wheel = vz.flow_color_wheel(flow)
    assert wheel.shape == (h, w, 3) and wheel.dtype == np.uint8
    # zero-flow pixels get the dim base value (V = 0.25*255 = 63)
    assert wheel[0, -1].max() == 63
    # moving pixels are brighter than still ones
    assert wheel[0, 0].max() > wheel[0, -1].max()

    img = np.full((h, w, 4), 200, np.uint8)
    field = vz.flow_as_vector_field(flow, img)
    assert field.shape == (h, w, 3)
    assert (field < 200).any()  # arrows drawn

    stacked = vz.stack_horizontal([wheel, wheel])
    assert stacked.shape == (h, 2 * w, 3)
