"""Neuron-axis model parallelism via ``shard_map``.

The reference farms per-neuron GLM subproblems out to IPython.parallel
engines (``parallel_coord_descent.py``, SURVEY.md §2/§3.2) — legal because
the likelihood factorizes over *postsynaptic* neurons. The equivalent
here shards the postsynaptic axis of the parameters (rows of A, W,
w_ir; entries of bias; rows of w_stim) and of the spike matrix across a
device mesh: each chip computes its neuron block's likelihood against the
fully-replicated presynaptic design tensor X_imp, and a single ``psum`` over
the interconnect produces the scalar objective. Gradients flow through the same sharding
(GSPMD), so one L-BFGS/HMC step *is* the reference's "engines fit their
neurons, client gathers" round — without a client.

Divisibility: N must be a multiple of the mesh axis size (pad the population
or choose the mesh accordingly).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["neuron_partition_specs", "make_sharded_value_and_grad"]

_REPLICATED_KEYS = ("pi", "Bm", "rho", "W_mu", "W_sigma")  # global hypers: replicate


def neuron_partition_specs(params: dict, data: dict, axis: str = "neurons"):
    """PartitionSpec pytrees sharding the postsynaptic axis of params/data."""
    p_specs = {
        k: (P() if k in _REPLICATED_KEYS else P(axis)) for k in params
    }
    d_specs = {}
    for k in data:
        if k == "S":
            d_specs[k] = P(None, axis)  # (T, N_post)
        else:
            d_specs[k] = P()  # design tensors replicated (presynaptic axis)
    return p_specs, d_specs


def make_sharded_value_and_grad(pop, mesh: Mesh, params: dict, data: dict, axis: str = "neurons"):
    """Build ``value_and_grad`` of −log_joint with the neuron axis sharded.

    Every component current/likelihood function is written row-sliceable
    (postsynaptic-major leaves), so the *same* model code runs on each shard
    with local shapes; only the final scalar reduction crosses chips.
    """
    p_specs, d_specs = neuron_partition_specs(params, data, axis)

    @jax.shard_map(mesh=mesh, in_specs=(p_specs, d_specs), out_specs=P())
    def sharded_ll(params, data):
        return jax.lax.psum(pop.log_likelihood(params, data), axis)

    def objective(params, data):
        return -(sharded_ll(params, data) + pop.log_prior(params))

    return jax.jit(jax.value_and_grad(objective))
