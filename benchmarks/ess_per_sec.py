#!/usr/bin/env python
"""HMC ESS/sec on the 27-neuron network GLM — the second BASELINE.md metric.

Runs the full Gibbs/HMC sampler (HMC blocks + collapsed (A,W) birth–death +
latent-location updates) on synthetic data from the flagship
distance-dependent model (acceptance config 5's family). Compilation is
excluded: both sweep variants are compiled first, then a steady-state window
is timed. Reports ESS/sec for the coupling weights W and the projected
wall-clock of the 10k-iteration north star.

  python benchmarks/ess_per_sec.py [--N 27] [--T 60000] [--n_samples 300]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--N", type=int, default=27)
    p.add_argument("--T", type=int, default=60_000)
    p.add_argument("--n_samples", type=int, default=300)
    p.add_argument("--n_warmup", type=int, default=100)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from theano_pyglm_tpu import Population, make_model
    from theano_pyglm_tpu.inference.mcmc import _run_chunk, init_mcmc_state, make_sweep
    from theano_pyglm_tpu.utils.diagnostics import ess
    from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    pop = Population(make_model("distance_weighted_model", args.N))
    true = pop.sample(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    stim = rng.randn(args.T, 1).astype(np.float32)
    S, rates = pop.simulate(jax.random.PRNGKey(1), true, args.T, stim=stim)
    data = pop.prepare_data(S, stim=stim)
    print(
        f"data: N={args.N} T={args.T} spikes={float(np.asarray(S).sum()):.0f} "
        f"({float(np.asarray(rates).mean()):.1f} Hz)",
        file=sys.stderr,
    )

    sweep = make_sweep(pop, data)
    state = init_mcmc_state(pop, true)
    key = jax.random.PRNGKey(2)

    # compile both variants + adapt during warmup. The collect-variant warm
    # chunk uses the SAME length as the timed chunk (chunk length is a static
    # jit arg — a different length would recompile inside the timing window).
    key, k = jax.random.split(key)
    state, _ = _run_chunk(sweep, args.n_warmup, k, state, jnp.asarray(True), 0,
                          None, data)
    key, k = jax.random.split(key)
    state, _ = _run_chunk(sweep, args.n_samples, k, state, jnp.asarray(False), 1,
                          None, data)
    jax.block_until_ready(state)

    # steady-state timed window
    t0 = time.perf_counter()
    key, k = jax.random.split(key)
    state, samples = _run_chunk(sweep, args.n_samples, k, state,
                                jnp.asarray(False), 1, None, data)
    jax.block_until_ready(samples)
    wall = time.perf_counter() - t0

    W = np.asarray(samples["W"])[:, None]  # (draws, 1 chain, N, N)
    ess_W = ess(W)
    med_ess = float(np.nanmedian(ess_W))
    per_sweep = wall / args.n_samples
    print(
        json.dumps(
            {
                "metric": f"hmc_gibbs_ess_per_sec_W_N{args.N}",
                "value": round(med_ess / wall, 3),
                "unit": "ESS/s (median over W entries)",
                "min_ess_per_sec": round(float(np.nanmin(ess_W)) / wall, 4),
                "ms_per_sweep": round(per_sweep * 1e3, 2),
                "projected_10k_iters_minutes": round(per_sweep * 10_000 / 60, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
