#!/usr/bin/env python
"""Per-stage decomposition of the flagship Gibbs sweep (N=27, T=60k).

Times each update group of the sweep in isolation via
``make_sweep(stages=(...,))`` — the glm Laplace block, the impulse HMC
block, the latent-location HMC block, the conjugate hyper updates, the
collapsed (A, W) birth–death sweep, the discrete (SBM/ER) updates, and the
orientation-gauge rotation draw — plus the full sweep and the 4-chain
vmapped full sweep (the flagship configuration). Every measurement runs
``--reps`` iterations inside ONE ``lax.scan`` execution so the host's
dispatch cost is amortized out (an under-amortized probe measures the host,
not the device).

Stage times are measured independently, so their sum can differ from the
full-sweep time by (±) XLA fusion across stage boundaries and the fixed
per-iteration key-split overhead; the residual is reported.

  python benchmarks/sweep_profile.py [--N 27] [--T 60000] [--reps 300]
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
    p.add_argument("--reps", type=int, default=300)
    p.add_argument("--n_chains", type=int, default=4)
    p.add_argument("--n_warmup", type=int, default=100)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from theano_pyglm_tpu import Population, make_model
    from theano_pyglm_tpu.inference.mcmc import (
        SWEEP_STAGES,
        _run_chunk,
        init_mcmc_state,
        make_sweep,
    )
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

    # Realistic state: adapt the full sweep for n_warmup iterations first so
    # step sizes/acceptance are what the sampling phase actually sees.
    full = make_sweep(pop, data)
    state = init_mcmc_state(pop, true)
    key = jax.random.PRNGKey(2)
    key, k = jax.random.split(key)
    state, _ = _run_chunk(full, args.n_warmup, k, state, jnp.asarray(True), 0,
                          None, data)
    jax.block_until_ready(state)

    def timed(sweep, st, reps, tag):
        """reps iterations in one scan execution; returns ms/iteration."""
        k_tag = jax.random.fold_in(jax.random.PRNGKey(3), hash(tag) % (2**31))
        # compile (same static shape as the timed call); data rides as a
        # traced arg so the compile upload is O(program), not O(T·N·B)
        out, _ = _run_chunk(sweep, reps, k_tag, st, jnp.asarray(False), 0,
                            None, data)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out, _ = _run_chunk(sweep, reps, jax.random.fold_in(k_tag, 1), st,
                            jnp.asarray(False), 0, None, data)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps * 1e3

    rows = {}
    for stage in SWEEP_STAGES:
        sweep_s = make_sweep(pop, data, stages=(stage,), diagnostic=True)
        rows[stage] = timed(sweep_s, state, args.reps, stage)
        print(f"  {stage:10s} {rows[stage]:8.3f} ms", file=sys.stderr)

    ms_full = timed(full, state, args.reps, "full")
    print(f"  {'FULL':10s} {ms_full:8.3f} ms", file=sys.stderr)

    # 4-chain vmapped full sweep (the flagship path: chains are a batch axis)
    n_c = args.n_chains
    states_c = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_c,) + jnp.shape(x)), state
    )
    chain_sweep = jax.vmap(full, in_axes=(0, 0, None, None, None))

    def chains_as_sweep(k, st, adapt, beta=1.0, d=None):
        return chain_sweep(jax.random.split(k, n_c), st, adapt, beta, d)

    ms_chains = timed(chains_as_sweep, states_c, args.reps, "chains")
    print(
        f"  {'FULL x' + str(n_c):10s} {ms_chains:8.3f} ms "
        f"({ms_chains / n_c:.3f} ms/chain-sweep)",
        file=sys.stderr,
    )

    stage_sum = sum(rows.values())
    print(
        json.dumps(
            {
                "metric": f"gibbs_sweep_profile_N{args.N}_T{args.T}",
                "value": round(ms_full, 3),
                "unit": "ms/sweep (full, single chain)",
                "per_stage_ms": {k: round(v, 3) for k, v in rows.items()},
                "stage_sum_ms": round(stage_sum, 3),
                "residual_ms": round(ms_full - stage_sum, 3),
                "chains4_ms_per_iter": round(ms_chains, 3),
                "chains4_ms_per_chain_sweep": round(ms_chains / n_c, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
