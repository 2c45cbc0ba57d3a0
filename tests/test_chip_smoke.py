"""chip_smoke.py: every phase at a tiny size on the CPU, the refusal to run
without a GPU, and (marked ``gpu``) the whole script on a card.

The phases run in float32, as on the card; the sharded phases use the CPU's
virtual devices (tests/conftest.py provides eight).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from theano_pyglm_tpu.utils.device import describe_gpu, nvidia_smi  # noqa: E402

N, T = 4, 2000


@pytest.fixture(scope="module")
def f32():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def flagship(f32):
    return chip_smoke.build_flagship(0, N=N, T=T, card="cpu")


@pytest.fixture(scope="module")
def clock():
    c = chip_smoke.CompileClock()
    yield c
    c.close()


def test_device_phase_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        describe_gpu(1)


def test_phase_oracle(flagship):
    _, pop, true, _, _, data, _ = flagship
    val, grad = chip_smoke.phase_oracle(pop, true, data, "cpu")
    assert np.isfinite(val)
    assert set(grad) == {"bias", "w_stim", "w_ir", "W", "locs"}


def test_phase_map(flagship):
    _, pop, true, _, _, data, _ = flagship
    fit = chip_smoke.phase_map(pop, data, true, "cpu")
    assert np.all(np.isfinite(np.asarray(fit["W"])))


def test_phase_mcmc(flagship, clock):
    _, pop, true, _, _, data, key = flagship
    samples = chip_smoke.phase_mcmc(pop, data, true, key, "cpu", clock,
                                    n_warmup=2, n_samples=2)
    assert samples["W"].shape == (2, 4, N, N)


def test_phase_streaming(flagship):
    spec, pop, true, stim, S, data, _ = flagship
    ref = chip_smoke.phase_oracle(pop, true, data, "cpu", n_per_leaf=1)
    chip_smoke.phase_streaming(spec, true, S, stim, ref, "cpu", time_chunk=512)


def test_four_chains_on_virtual_devices(flagship, clock):
    _, pop, true, _, _, data, key = flagship
    chip_smoke.four_chains(pop, data, true, key, "cpu", clock,
                           n_warmup=1, n_samples=2)


def test_four_neurons_on_virtual_devices(f32):
    chip_smoke.four_neurons(0, "cpu", N=8, T=T)


def test_compile_clock_merges_nested_spans():
    c = chip_smoke.CompileClock()
    c.close()
    c.spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (10.0, 20.0)]
    assert c.seconds(0.0, 12.0) == pytest.approx(3.0 + 1.0 + 2.0)


def _run_script(env, *args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )


def test_script_exits_nonzero_on_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run_script(env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


@pytest.fixture
def gpu_env():
    """An environment for a child process that may open the card; skips
    unless nvidia-smi answers. This process stays on the CPU."""
    if nvidia_smi() is None:
        pytest.skip("no NVIDIA GPU visible (nvidia-smi did not answer)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.gpu
def test_script_passes_on_a_gpu(gpu_env):
    proc = _run_script(gpu_env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] >= 1
