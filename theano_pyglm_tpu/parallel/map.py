"""Neuron-sharded MAP — ≅ ``parallel_coord_descent.py`` (SURVEY.md §2).

The reference pushes data and model to IPython.parallel engines, each engine
L-BFGS-fits its neuron subset, and the client gathers. Here the *same* joint
L-BFGS loop as :func:`theano_pyglm_tpu.inference.map.map_fit` runs with the
postsynaptic axis sharded over a device mesh (shard_map objective from
:mod:`theano_pyglm_tpu.parallel.neurons`): every chip owns N/k neurons'
parameter rows, gradients stay chip-local, and the only communication is the
scalar ``psum`` per objective evaluation — one collective per L-BFGS step
over the device interconnect.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from theano_pyglm_tpu.inference.map import lbfgs_minimize, split_params
from theano_pyglm_tpu.parallel.neurons import neuron_partition_specs

__all__ = ["parallel_map_fit"]


def parallel_map_fit(pop, data, init_params, mesh: Mesh, max_iter: int = 500):
    """MAP with the neuron axis sharded over ``mesh`` (axis name 'neurons').

    N must be divisible by the mesh size. Returns (params, log_joint, iters)
    exactly like ``map_fit`` — same math, distributed execution.
    """
    p_specs, d_specs = neuron_partition_specs(init_params, data)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    params0 = {k: put(v, p_specs[k]) for k, v in init_params.items()}
    data_sh = {k: put(v, d_specs[k]) for k, v in data.items() if hasattr(v, "shape")}
    for k, v in data.items():
        if not hasattr(v, "shape"):
            data_sh[k] = v

    opt0, frozen = split_params(params0)

    @jax.shard_map(
        mesh=mesh,
        in_specs=({k: p_specs[k] for k in opt0},
                  {k: p_specs[k] for k in frozen},
                  {k: d_specs[k] for k in data_sh}),
        out_specs=P(),
    )
    def sharded_nll(opt, frozen, data):
        return jax.lax.psum(-pop.log_likelihood({**frozen, **opt}, data), "neurons")

    def objective(opt):
        # priors are separable row-wise but cheap — evaluate replicated
        return sharded_nll(opt, frozen, data_sh) - pop.log_prior({**frozen, **opt})

    fit = jax.jit(lambda o: lbfgs_minimize(objective, o, max_iter=max_iter))
    opt, val, iters = fit(opt0)
    return {**frozen, **opt}, -val, iters
