"""Multi-host distribution test: REAL multi-process jax.distributed run on
localhost (CPU backend, 2 processes × 2 virtual devices = 4 global devices),
chains sharded over the global mesh — SURVEY.md §5 "Distributed backend" /
round-1 VERDICT item 10. Each worker runs the identical program; the test
checks both workers produce the full, identical sample stack and that it
matches a single-process run of the same configuration.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=2").strip()
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from theano_pyglm_tpu.parallel import distributed as dist

multi = dist.initialize()
import numpy as np
from theano_pyglm_tpu import Population, make_model
from theano_pyglm_tpu.parallel import gibbs_sample_chains

assert (jax.device_count() == 4) == multi, (jax.device_count(), multi)

spec = make_model("sparse_weighted_model", 2, bkgd={"type": "none"})
pop = Population(spec)
true = pop.sample(jax.random.PRNGKey(0))
S, _ = pop.simulate(jax.random.PRNGKey(1), true, 200)
data = pop.prepare_data(S)
mesh = dist.global_chain_mesh()
samples, diag, _ = gibbs_sample_chains(
    pop, data, jax.random.PRNGKey(7), n_chains=4, n_samples=10, n_warmup=10,
    chunk_size=10, init_params=true, mesh=mesh,
)
out = os.environ["OUT_FILE"]
np.savez(out, W=samples["W"], A=samples["A"])
print("worker", os.environ.get("PROCESS_ID", "single"), "done", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(tmp_path, i, port, nprocs):
    env = dict(os.environ)
    env.update(
        REPO_ROOT=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        OUT_FILE=os.path.join(tmp_path, f"out_{i}.npz"),
        JAX_PLATFORMS="cpu",
    )
    env.pop("XLA_FLAGS", None)
    if nprocs > 1:
        env.update(
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            NUM_PROCESSES=str(nprocs),
            PROCESS_ID=str(i),
        )
    return env


@pytest.mark.slow
def test_two_process_chains_match_single_process(tmp_path):
    tmp_path = str(tmp_path)
    port = _free_port()

    # single-process reference (same program, no coordinator)
    ref = subprocess.run(
        [sys.executable, "-c", _WORKER], env=_env(tmp_path, "ref", port, 1),
        capture_output=True, text=True, timeout=900,
    )
    assert ref.returncode == 0, ref.stderr[-2000:]

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=_env(tmp_path, i, port, 2),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]

    with np.load(os.path.join(tmp_path, "out_ref.npz")) as z:
        W_ref, A_ref = z["W"], z["A"]
    for i in range(2):
        with np.load(os.path.join(tmp_path, f"out_{i}.npz")) as z:
            assert z["W"].shape == W_ref.shape == (10, 4, 2, 2)
            np.testing.assert_allclose(z["W"], W_ref, rtol=1e-10)
            np.testing.assert_array_equal(z["A"], A_ref)
