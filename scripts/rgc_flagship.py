#!/usr/bin/env python
"""Acceptance config 5 — the flagship run (BASELINE.md):

N=27 RGC-scale distance-dependent (latent-location) network GLM, 60 s @ 1 ms
synthetic data, 10,000-iteration joint MCMC (HMC + collapsed (A,W)
birth–death + latent-location updates), multiple chains. Real RGC recordings
aren't shipped (offline environment); the synthetic stand-in matches the
published setup's scale (27 cells, ~100 s, Pillow et al. 2008 style stimulus
filtering; SURVEY.md §4).

  python scripts/rgc_flagship.py [--n_iters 10000] [--n_chains 4] [-r results/rgc]
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
    p.add_argument("--T_sec", type=float, default=60.0)
    p.add_argument("--n_iters", type=int, default=10_000)
    p.add_argument("--n_warmup", type=int, default=1_000)
    p.add_argument("--n_chains", type=int, default=4)
    p.add_argument("--thin", type=int, default=10)
    p.add_argument("--resultsDir", "-r", type=str, default="results/rgc_flagship")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax

    from theano_pyglm_tpu import Population, make_model
    from theano_pyglm_tpu.parallel import chain_mesh, gibbs_sample_chains
    from theano_pyglm_tpu.utils.diagnostics import summarize_chains
    from theano_pyglm_tpu.utils.io import save_results
    from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    spec = make_model("distance_weighted_model", args.N)
    # RGC-realistic firing rates (~20 Hz baseline; Pillow et al. 2008 cells)
    spec["bias"] = {"mu": 3.0, "sigma": 0.4}
    pop = Population(spec)
    key = jax.random.PRNGKey(args.seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    true = pop.sample(k1)
    T = int(round(args.T_sec / pop.dt))
    stim = np.asarray(jax.random.normal(k2, (T, 1)), np.float32)
    t0 = time.time()
    S, rates = pop.simulate(k3, true, T, stim=stim)
    print(
        f"simulated {float(np.asarray(S).sum()):.0f} spikes "
        f"({float(np.asarray(rates).mean()):.1f} Hz) in {time.time()-t0:.1f}s",
        flush=True,
    )
    data = pop.prepare_data(S, stim=stim)

    # MAP-start the chains (jittered): prior-draw inits leave long warmup
    # transients that can poison a chain's adaptation window.
    from theano_pyglm_tpu.inference import map_fit
    from theano_pyglm_tpu.inference.smart_init import smart_initialize

    t0 = time.time()
    init, map_logp, _ = map_fit(pop, data, smart_initialize(pop, data))
    print(f"MAP init: log-joint {float(map_logp):.1f} in {time.time()-t0:.1f}s", flush=True)

    mesh = chain_mesh() if len(jax.devices()) > 1 else None
    t0 = time.time()
    samples, diag, _ = gibbs_sample_chains(
        pop,
        data,
        k4,
        n_chains=args.n_chains,
        n_samples=args.n_iters // args.thin,
        n_warmup=args.n_warmup,
        thin=args.thin,
        # Sweeps per device chunk: the callback reports progress once per
        # chunk. 250 is an inherited value; ROADMAP S2 sizes it from the
        # measured dispatch and transfer share of this run on the H100.
        chunk_size=250,
        mesh=mesh,
        init_params=init,
        init_jitter=0.05,
        callback=lambda ph, it, st: print(
            f"  {ph} {it} @ {time.time()-t0:.0f}s", flush=True
        ),
    )
    wall = time.time() - t0
    conv = summarize_chains(samples)
    if "locs" in samples:
        # Raw location coordinates are orientation-gauge: the sampler mixes
        # the rotation orbit exactly (gibbs.update_latent_rotation), so their
        # R-hat/ESS measure the (instantly-mixed) gauge. Also diagnose the
        # IDENTIFIABLE functions — pairwise distances — so slow mixing of the
        # actual embedding shape cannot hide behind orbit randomization.
        L = np.asarray(samples["locs"])  # (n_draws, n_chains, N, D)
        iu = np.triu_indices(L.shape[2], k=1)
        d = np.linalg.norm(
            L[:, :, :, None, :] - L[:, :, None, :, :], axis=-1
        )[:, :, iu[0], iu[1]]
        conv.update(summarize_chains({"locs_pairwise_dist": d}))
    A_post = samples["A"].mean(axis=(0, 1))
    A_true = np.asarray(true["A"])
    # link-prediction AUC (the paper's headline qualitative metric)
    th = np.sort(np.unique(A_post))[::-1]
    tpr = [(A_post[A_true == 1] >= t).mean() for t in th]
    fpr = [(A_post[A_true == 0] >= t).mean() for t in th]
    auc = float(np.trapezoid(tpr, fpr))

    summary = {
        "wall_clock_s": round(wall, 1),
        "iters": args.n_iters + args.n_warmup,
        "n_chains": args.n_chains,
        "ms_per_iteration": round(wall / (args.n_iters + args.n_warmup) * 1e3, 2),
        "link_prediction_auc": round(auc, 3),
        "convergence": {k: {kk: round(vv, 3) for kk, vv in v.items()} for k, v in conv.items()},
    }
    print(json.dumps(summary, indent=2))
    save_results(
        os.path.join(args.resultsDir, "flagship_samples.npz"),
        {"samples": samples, "true_params": {k: np.asarray(v) for k, v in true.items()}},
    )
    with open(os.path.join(args.resultsDir, "flagship_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
        f.write("\n")


if __name__ == "__main__":
    main()
