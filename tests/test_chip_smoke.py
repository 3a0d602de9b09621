"""chip_smoke.py's device gate: it runs only where JAX finds the GPU."""

import types

import jax
import pytest

import chip_smoke


def test_device_check_refuses_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(chip_smoke.SmokeFailure, match="needs an NVIDIA GPU"):
        chip_smoke.device_check(jax)


def test_main_exits_nonzero_and_prints_no_result_on_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_device_check_reports_the_gpu():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    fake = types.SimpleNamespace(devices=lambda: [dev] * 4)
    assert chip_smoke.device_check(fake) == {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 4}
