"""The Pallas (Triton) relax kernel in interpret mode against its jnp
reference, plus the one place that chooses between them.

The card runs the compiled kernel (``chip_smoke.py`` phase 1 compares it
with the reference at the 36 MP finest level); here the same kernel body
runs through Pallas' interpreter on the CPU.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from panorama_opticalflow_tpu.models import pixflow
from panorama_opticalflow_tpu.ops import relax_fast as rf
from panorama_opticalflow_tpu.ops.pallas import relax
from panorama_opticalflow_tpu.utils.config import flow_params_by_name


def _inputs(rng, shape):
    mk = lambda s=0.1: rng.standard_normal(shape).astype(np.float32) * s  # noqa: E731
    flow = np.stack([mk(0.5), mk(0.5)], -1)
    return [jnp.asarray(a) for a in (
        flow, flow + np.stack([mk(0.6), mk(0.6)], -1),
        np.stack([mk(), mk()], -1), mk(), mk(),
        np.stack([mk(0.5), mk(0.5)], -1), rng.random(shape) > 0.1)]


def _params(fold=True):
    return dataclasses.replace(flow_params_by_name("pixflow_low"),
                               fold_descent_sample=fold)


def _check(got, ref):
    # interpreted kernel vs XLA:CPU: the same f32 operations in the same
    # order, up to contraction of multiply-adds
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("fold,D", [(True, 2), (False, 2), (True, 3),
                                    (False, 3)])
def test_relax_kernel_matches_jnp(rng, fold, D):
    a = _inputs(rng, (24, 128))
    p = _params(fold)
    ref = rf.relax_phase_fast(*a, p, 2, D)
    got = relax.relax_phase_kernel(*a, p, 2, D, interpret=True)
    _check(got, ref)


@pytest.mark.parametrize("shape", [(13, 70), (5, 33), (40, 200)])
def test_relax_kernel_ragged_shapes(rng, shape):
    """Shapes that are not a multiple of the program tile, including
    images shorter than the descent's row window (2D+1 rows)."""
    a = _inputs(rng, shape)
    p = _params()
    _check(relax.relax_phase_kernel(*a, p, 3, 2, interpret=True),
           rf.relax_phase_fast(*a, p, 3, 2))


def test_relax_kernel_vmapped_batch(rng):
    """pallas_call's own batching rule carries the direction batch."""
    a = _inputs(rng, (2, 21, 90))
    p = _params()
    ref = jax.vmap(lambda *z: rf.relax_phase_fast(*z, p, 2, 2))(*a)
    got = jax.vmap(lambda *z: relax.relax_phase_kernel(
        *z, p, 2, 2, interpret=True))(*a)
    _check(got, ref)


def test_relax_kernel_tile_invariant(rng):
    """The program tile and warp count change nothing but speed."""
    a = _inputs(rng, (19, 100))
    p = _params()
    outs = [np.asarray(relax.relax_phase_kernel(
        *a, p, 2, 2, block=blk, num_warps=nw, interpret=True))
        for blk, nw in (((8, 64), 4), ((4, 32), 2), ((16, 128), 8))]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


@pytest.mark.parametrize("platform,expect", [("gpu", True), ("cpu", False)])
def test_kernel_platform(platform, expect):
    assert relax.kernel_platform(platform) is expect


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_kernel_platform_rejects_other_backends(platform):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        relax.kernel_platform(platform)


def test_use_relax_kernel_threshold(monkeypatch):
    n = relax.MIN_PIXELS
    assert relax.use_relax_kernel(n // 64, 64, "gpu")
    assert not relax.use_relax_kernel(n // 64 - 1, 64, "gpu")
    assert not relax.use_relax_kernel(n, n, "cpu")
    monkeypatch.setattr(relax, "MIN_PIXELS", 0)
    assert relax.use_relax_kernel(1, 1, "gpu")


@pytest.fixture
def kernel_in_interpreter(monkeypatch):
    """Dispatch as on the GPU, with the kernel run by the interpreter."""
    call = relax._relax_call
    monkeypatch.setattr(relax, "kernel_platform", lambda platform=None: True)
    monkeypatch.setattr(relax, "_relax_call",
                        lambda *a: call(*a[:-1], True))


def test_level_core_dispatches_to_kernel(rng, kernel_in_interpreter):
    """A fast-path level above the threshold relaxes through the kernel
    and matches the CPU level."""
    imgs = jnp.asarray(rng.random((2, 40, 96)).astype(np.float32))
    alphas = jnp.ones((2, 40, 96), jnp.float32)
    flow = jnp.asarray(rng.normal(0, 0.5, (2, 40, 96, 2)).astype(np.float32))
    p = flow_params_by_name("pixflow_low")
    calls = []
    orig = relax.relax_phase_batched
    with pytest.MonkeyPatch.context() as m:
        m.setattr(relax, "MIN_PIXELS", 0)
        m.setattr(relax, "relax_phase_batched",
                  lambda *a: calls.append(1) or orig(*a))
        got = pixflow.patch_match_level_batched(imgs, alphas, flow,
                                                ("left", "right"), p)
    assert calls
    with pytest.MonkeyPatch.context() as m:
        m.setattr(relax, "MIN_PIXELS", 10 ** 12)
        m.setattr(relax, "relax_phase_batched",
                  lambda *a: calls.append(2) or orig(*a))
        ref = pixflow.patch_match_level_batched(
            imgs, alphas, flow, ("left", "right"), p)
    assert 2 not in calls
    _check(got, ref)


@pytest.mark.parametrize("axis", ["y", None])
def test_partitioned_kernel_over_tile_batch(rng, kernel_in_interpreter, axis):
    """The one-kernel shard_map splits the tile batch over the mesh
    (``axis``), or runs it whole on every device (``None``, the hybrid
    solver's replicated levels)."""
    from panorama_opticalflow_tpu.ops.pallas.partition import (
        PartitionedKernels)
    from panorama_opticalflow_tpu.parallel.mesh import make_mesh

    a = _inputs(rng, (4, 16, 72))
    p = _params()
    got = PartitionedKernels(make_mesh(2), axis).relax_phase_batched(
        *a, p, 2, 2)
    ref = jax.vmap(lambda *z: rf.relax_phase_fast(*z, p, 2, 2))(*a)
    _check(got, ref)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_relax_kernel_compiled_on_gpu(rng, gpu):
    a = _inputs(rng, (2, 200, 300))
    p = _params()
    ref = jax.vmap(lambda *z: rf.relax_phase_fast(*z, p, 3, 2))(*a)
    got = relax.relax_phase_batched(*a, p, 3, 2)
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert d.mean() <= 1e-5 and np.quantile(d, 0.9999) <= 1e-3
