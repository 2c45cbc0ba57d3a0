#!/usr/bin/env python
"""Run the five BASELINE.json acceptance configs end-to-end and emit a JSON
report. Full scale by default (run it on a GPU); ``--quick`` shrinks sizes
for a CPU smoke pass.

  1. single-neuron standard GLM, 60 s @ 1 ms, MAP
  2. N=10 Erdős–Rényi network, sparse MAP + cross-validated λ
  3. N=10 network, full HMC, 4 parallel chains
  4. N=16 SBM latent-type model, collapsed Gibbs + HMC
  5. N=27 distance-dependent model, 10k-iter joint MCMC (see rgc_flagship.py
     for the multi-chain flagship; here a reduced single-chain pass unless
     --full5)
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny sizes (CPU smoke)")
    ap.add_argument("--full5", action="store_true", help="run config 5 at full 10k iters")
    ap.add_argument("--resultsDir", "-r", default="results/acceptance")
    args = ap.parse_args()
    q = args.quick

    import jax

    from theano_pyglm_tpu import Population, make_model
    from theano_pyglm_tpu.inference import (
        cross_validate_lambda,
        gibbs_sample,
        map_fit,
        sparse_map_fit,
    )
    from theano_pyglm_tpu.inference.smart_init import smart_initialize
    from theano_pyglm_tpu.parallel import gibbs_sample_chains
    from theano_pyglm_tpu.utils.diagnostics import summarize_chains
    from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    report = {}
    rng = np.random.RandomState(0)

    def synth(name, N, T, seed=0, **over):
        spec = make_model(name, N, **over)
        spec["bias"] = {"mu": 2.5, "sigma": 0.4}
        pop = Population(spec)
        true = pop.sample(jax.random.PRNGKey(seed))
        stim = rng.randn(T, 1).astype(np.float32) if pop.basis_stim is not None else None
        S, rates = pop.simulate(jax.random.PRNGKey(seed + 1), true, T, stim=stim)
        return pop, true, S, stim

    # ---- config 1: single-neuron standard GLM, MAP.
    # Wall-clock is decomposed (simulate / MAP-compile / MAP-run): the
    # round-2 report showed a 4x regression in this config's total with no
    # attribution — the split separates XLA compile + simulate dispatch
    # overhead from actual optimization time.
    t0 = time.time()
    T1 = 5_000 if q else 60_000
    pop, true, S, stim = synth("standard_glm", 1, T1)
    t_sim = time.time() - t0
    data = pop.prepare_data(S, stim=stim)
    init1 = smart_initialize(pop, data)
    t1 = time.time()
    fit, logp, iters = map_fit(pop, data, init1)  # includes XLA compile
    jax.block_until_ready(fit)
    t_map_cold = time.time() - t1
    t1 = time.time()
    fit, logp, iters = map_fit(pop, data, init1)  # compiled
    jax.block_until_ready(fit)
    t_map_warm = time.time() - t1
    report["config1_standard_glm_map"] = {
        "log_joint": float(logp),
        "log_joint_at_truth": float(pop.log_joint(true, data)),
        "map_beats_truth": bool(float(logp) >= float(pop.log_joint(true, data)) - 1e-3),
        "iters": int(iters),
        "simulate_s": round(t_sim, 1),
        "map_cold_s": round(t_map_cold, 1),
        "map_warm_s": round(t_map_warm, 1),
        "compile_overhead_s": round(t_map_cold - t_map_warm, 1),
        "wall_s": round(time.time() - t0, 1),
    }
    print("config 1 done", report["config1_standard_glm_map"], flush=True)

    # ---- config 2: N=10 ER, sparse MAP + xv lambda (+ support recovery)
    # Identifiable planted weights (|W|=2.5 on the sampled ER edges): a
    # prior draw W ~ N(0,2) leaves about half the edges statistically
    # undetectable at this T, which turns the xv score flat and the support
    # metric meaningless.
    #
    # T = 240k (4 min @ 1 ms): measured per-edge information at T=30k gives
    # true-edge Wald z of only 0.4-4.6 (NOT the z~25 a dense-design estimate
    # suggests — psi is nonzero only in the ~50 ms after each presynaptic
    # spike), so no pruning rule can reach F1 0.8 there; even the EXACT
    # posterior at T=120k leaves 4-6 planted edges at P(edge) < 0.5. At
    # T=240k the exact posterior separates cleanly (probe: precision 1.0,
    # recall 0.875, the two missed edges sit at P about 0.18 — structurally
    # weak, invisible to any method at this T).
    t0 = time.time()
    T2 = 4_000 if q else 240_000
    spec2 = make_model("sparse_weighted_model", 10)
    spec2["bias"] = {"mu": 2.5, "sigma": 0.4}
    pop = Population(spec2)
    true = dict(pop.sample(jax.random.PRNGKey(0)))
    rng2 = np.random.RandomState(20)
    W2p = np.where(rng2.rand(10, 10) < 0.7, 2.5, -2.5).astype(np.float32)
    np.fill_diagonal(W2p, -2.0)
    true["W"] = jax.numpy.asarray(W2p) * true["A"]
    stim = rng.randn(T2, 1).astype(np.float32)
    S, _ = pop.simulate(jax.random.PRNGKey(1), true, T2, stim=stim)
    init = smart_initialize(pop, pop.prepare_data(S, stim=stim))
    init["A"] = np.ones((10, 10))
    # wide log-spaced grid (interior winner expected) + 3-fold xv with
    # warm-started lasso path — see cross_validate_lambda
    lambdas = [1.0, 10.0] if q else [0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0]
    best, fits, scores = cross_validate_lambda(
        pop, S, stim, init, lambdas, max_iter=100 if q else 300,
        n_folds=1 if q else 3,
    )
    data2 = pop.prepare_data(S, stim=stim)
    params2, logp2, _ = sparse_map_fit(pop, data2, init, best, max_iter=100 if q else 400)
    off = ~np.eye(10, dtype=bool)
    W2 = np.asarray(params2["W"])
    from theano_pyglm_tpu.utils.diagnostics import support_metrics

    A_true2 = np.asarray(true["A"])
    true_density = float(A_true2[off].mean())

    # Debiased Wald pruning (uses NO ground truth): (1) refit UNPENALIZED
    # with A clamped to the lasso support (debiased weights); (2) per-edge
    # Wald test: SE_ij = 1/sqrt(Fisher_ij) with
    # Fisher_ij = sum_t lambda_t*dt*psi_ij(t)^2 (exp-Poisson); keep edges
    # with |W_refit| >= 2*SE. Reported as a DIAGNOSTIC: the diagonal-Fisher
    # SE ignores the correlation between edges into the same postsynaptic
    # neuron, so it overstates uncertainty and costs recall (measured F1
    # ~0.64 at T=240k) — the exact posterior below is the headline support
    # estimate.
    import jax.numpy as jnp
    from theano_pyglm_tpu.inference.gibbs import compute_psi, rest_current

    support0 = (np.abs(W2) >= 0.05).astype(np.float32)
    np.fill_diagonal(support0, 1.0)
    params2d = dict(params2)
    params2d["A"] = jnp.asarray(support0)
    refit, _, _ = map_fit(pop, data2, params2d, max_iter=100 if q else 300)
    W2d = np.asarray(refit["W"])
    psi = compute_psi(pop, refit, data2)  # (T, N_post, N_pre)
    I_tot = rest_current(pop, refit, data2) + jnp.einsum(
        "tnm,nm->tn", psi, refit["A"] * refit["W"]
    )
    lam_dt = pop.nlin.rate(I_tot) * pop.dt  # (T, N_post)
    fisher = np.asarray(jnp.einsum("tn,tnm->nm", lam_dt, psi * psi))
    se = 1.0 / np.sqrt(np.maximum(fisher, 1e-12))
    W2_wald = np.where(
        (support0 > 0) & (np.abs(W2d) >= 2.0 * se), W2d, 0.0
    )

    # Posterior support (BASELINE-sanctioned alternative to thresholded MAP
    # W): P(A_ij = 1 | data) from the exact collapsed (A,W) sampler,
    # lasso-warm-started; support = posterior median model (P > 1/2). The
    # posterior integrates the correlated design exactly — no Fisher
    # approximation — and the ER prior's learned density shrinks false
    # positives.
    from theano_pyglm_tpu.parallel import gibbs_sample_chains

    ns2 = 50 if q else 400
    samples2, _, _ = gibbs_sample_chains(
        pop, data2, jax.random.PRNGKey(9), n_chains=2,
        n_samples=ns2, n_warmup=max(50, ns2 // 2), chunk_size=min(200, ns2),
        init_params=dict(params2), init_jitter=0.05,
    )
    A_post2 = np.asarray(samples2["A"]).mean(axis=(0, 1))
    A_bayes = (A_post2 > 0.5).astype(np.float32)
    np.fill_diagonal(A_bayes, 0.0)
    report["config2_sparse_map_xv"] = {
        "best_lambda": float(best),
        "lambda_interior": bool(lambdas[0] < best < lambdas[-1]),
        "xv_scores": [round(s, 1) for s in scores],
        "offdiag_sparsity_frac_below_0.05": float((np.abs(W2[off]) < 0.05).mean()),
        "true_offdiag_density": true_density,
        "support_recovery_lasso": support_metrics(W2, A_true2, thresh=0.05),
        # W2_wald is already exactly zero off-support: threshold at ~0 so
        # the metric measures the Wald rule itself, not Wald AND |W|>=0.05
        "support_recovery_wald": support_metrics(W2_wald, A_true2, thresh=1e-9),
        "support_recovery": support_metrics(A_bayes, A_true2, thresh=0.5),
        "support_estimator": "posterior median model, P(A_ij|data) > 0.5, "
                             "2x400 draws collapsed (A,W) sampler",
        "log_joint": float(logp2),
        "wall_s": round(time.time() - t0, 1),
    }
    print("config 2 done", report["config2_sparse_map_xv"], flush=True)

    # ---- config 3: N=10 full HMC, 4 parallel chains. Chains start from a
    # shared MAP fit with per-chain jitter (the flagship's protocol): with
    # weak prior-drawn coupling the (A, W, filters) posterior is multimodal
    # and prior-initialized chains can settle in different modes — R-hat
    # then measures mode disagreement, i.e. luck, not the sampler.
    t0 = time.time()
    T3 = 3_000 if q else 30_000
    spec3 = make_model("sparse_weighted_model", 10)
    spec3["bias"] = {"mu": 2.5, "sigma": 0.4}
    pop = Population(spec3)
    true = dict(pop.sample(jax.random.PRNGKey(2)))
    rng3 = np.random.RandomState(30)
    W3p = np.where(rng3.rand(10, 10) < 0.7, 2.5, -2.5).astype(np.float32)
    np.fill_diagonal(W3p, -2.0)
    true["W"] = jax.numpy.asarray(W3p) * true["A"]  # identifiable edges (as config 2)
    stim = rng.randn(T3, 1).astype(np.float32)
    S, _ = pop.simulate(jax.random.PRNGKey(3), true, T3, stim=stim)
    data3 = pop.prepare_data(S, stim=stim)
    init3, _, _ = map_fit(pop, data3, smart_initialize(pop, data3),
                          max_iter=100 if q else 300)
    ns = 50 if q else 1000
    samples3, diag3, _ = gibbs_sample_chains(
        pop, data3, jax.random.PRNGKey(3), n_chains=4,
        n_samples=ns, n_warmup=max(200, ns // 2), chunk_size=min(200, ns),
        init_params=init3, init_jitter=0.05,
    )
    conv3 = summarize_chains(samples3)
    report["config3_hmc_4chains"] = {
        "n_samples_per_chain": ns,
        "max_rhat_W": round(conv3["W"]["max_rhat"], 3),
        "min_ess_W": round(conv3["W"]["min_ess"], 1),
        "max_rhat_bias": round(conv3["bias"]["max_rhat"], 3),
        "min_ess_bias": round(conv3["bias"]["min_ess"], 1),
        "wall_s": round(time.time() - t0, 1),
    }
    print("config 3 done", report["config3_hmc_4chains"], flush=True)

    # ---- config 4: N=16 SBM, collapsed Gibbs + HMC — PLANTED partition:
    # data generated from a strongly-blocked SBM; the sampler must recover
    # the blocks (label-permutation-invariant ARI vs truth). A prior draw
    # (round-1 protocol) often has statistically indistinguishable blocks,
    # which is what made "types_used: 1" uninformative.
    from theano_pyglm_tpu.utils.diagnostics import adjusted_rand_index

    t0 = time.time()
    T4 = 3_000 if q else 60_000
    N4 = 16
    spec4 = make_model("sbm_weighted_model", N4)
    # recipe validated at full scale: ~18 Hz rates and
    # fixed-magnitude planted weights make every edge statistically
    # identifiable at this T, so block recovery tests the sampler rather
    # than the data's information content
    spec4["bias"] = {"mu": 2.8, "sigma": 0.3}
    # tighter filter-shape prior: with σ=1.0 the per-pair filters and A
    # co-mix slowly enough that block recovery depends on sampler luck
    # (see tests/test_sbm_recovery.py for the full diagnosis)
    spec4["impulse"]["sigma"] = 0.5
    pop = Population(spec4)
    true = pop.sample(jax.random.PRNGKey(4))
    y_true = np.array([0] * (N4 // 2) + [1] * (N4 - N4 // 2))
    Bm_true = np.array([[0.7, 0.05], [0.05, 0.7]], dtype=np.float32)
    P4 = Bm_true[y_true[:, None], y_true[None, :]]
    rng4 = np.random.RandomState(4)
    A4 = (rng4.rand(N4, N4) < P4).astype(np.float32)
    np.fill_diagonal(A4, 1.0)
    W4 = np.where(rng4.rand(N4, N4) < 0.7, 2.5, -2.5).astype(np.float32)
    np.fill_diagonal(W4, -2.0)
    true = dict(true)
    true["y"], true["Bm"] = jax.numpy.asarray(y_true), jax.numpy.asarray(Bm_true)
    true["pi"] = jax.numpy.asarray([0.5, 0.5], np.float32)
    true["A"] = jax.numpy.asarray(A4)
    true["W"] = jax.numpy.asarray(W4 * A4)
    stim4 = rng.randn(T4, 1).astype(np.float32)
    S, _ = pop.simulate(jax.random.PRNGKey(5), true, T4, stim=stim4)
    data4 = pop.prepare_data(S, stim=stim4)
    ns = 50 if q else 1000
    n_chains4 = 2 if q else 4
    # Multi-chain protocol with ANNEALED warmup (round-3 verdict #1b): a
    # single un-annealed chain's block recovery was sampler-luck — the
    # canonical key parked at ARI 0.749 for 500 straight draws while alt
    # keys hit 1.0 (a self-consistent partial type assignment: wrong types
    # bias the block prior on A rows, the mis-inferred rows keep the types
    # wrong). Tempering the likelihood over the first half of warmup lets
    # (A, filters, y) co-mix before the posterior sharpens; validated at
    # this exact config: sampler keys {5, 15, 25} all reach ARI 1.0
    # (vs {0.749, 1.0, 1.0} without annealing). Four chains make the
    # evidence robust to residual luck: per-chain ARI + cross-chain type
    # agreement are reported, so one parked chain cannot hide.
    # 2000 sampling sweeps so the scored tail half sits PAST the slow mode:
    # with the collapsed type kernel the partial-assignment mode is
    # transient, not absorbing — a windowed-ARI probe (key 5, second data
    # realization, scripts/sbm_seed_robustness.py) shows
    # the slowest chain exiting to ARI 1.0 by sweep ~1000 and staying; at
    # ns=1000 the tail half could still straddle the escape.
    ns4 = 2 * ns
    samples4, diag4, _ = gibbs_sample_chains(
        pop, data4, jax.random.PRNGKey(5), n_chains=n_chains4,
        n_samples=ns4, n_warmup=ns, chunk_size=min(200, ns),
        init_params=smart_initialize(pop, data4), anneal_frac=0.5,
    )
    ns = ns4
    half = ns // 2
    # samples4 leaves are (n_samples, n_chains, ...)
    per_chain_ari, chain_modes = [], []
    for c in range(n_chains4):
        aris_c = [
            adjusted_rand_index(samples4["y"][i, c], y_true)
            for i in range(half, ns)
        ]
        per_chain_ari.append(round(float(np.mean(aris_c)), 3))
        # posterior-mode type per neuron over the tail (for agreement)
        tail = np.asarray(samples4["y"][half:, c])  # (half, N)
        chain_modes.append(
            np.array([np.bincount(tail[:, n]).argmax() for n in range(N4)])
        )
    cross = [
        adjusted_rand_index(chain_modes[i], chain_modes[j])
        for i in range(n_chains4)
        for j in range(i + 1, n_chains4)
    ]
    A_err = float(
        np.abs(samples4["A"][half:].mean(axis=(0, 1)) - np.asarray(true["A"])).mean()
    )
    report["config4_sbm"] = {
        "n_samples": ns,
        "n_chains": n_chains4,
        "anneal_frac": 0.5,
        "accept_rate": round(float(np.mean(np.asarray(diag4["accept_rate_glm"]))), 3),
        "planted_partition_ari_per_chain": per_chain_ari,
        "planted_partition_ari_min_chain": min(per_chain_ari),
        "cross_chain_type_agreement_ari": round(float(np.mean(cross)), 3),
        "adjacency_mean_abs_error": round(A_err, 3),
        "types_used": int(len(np.unique(samples4["y"][-1]))),
        "wall_s": round(time.time() - t0, 1),
    }
    print("config 4 done", report["config4_sbm"], flush=True)

    # ---- config 5: N=27 distance model joint MCMC
    t0 = time.time()
    T5 = 3_000 if q else 60_000
    n5 = 100 if q else (10_000 if args.full5 else 2_000)
    pop, true, S, stim = synth("distance_weighted_model", 27, T5, seed=6)
    data5 = pop.prepare_data(S, stim=stim)
    samples5, diag5, _ = gibbs_sample(
        pop, data5, jax.random.PRNGKey(7), n_samples=n5 // 10, thin=10,
        # warmup = a quarter of the run: with only n/10 warmup the frozen
        # step size decays into ~0.6 acceptance over the long sampling phase
        n_warmup=n5 // 4, chunk_size=min(500, n5 // 10),
    )
    report["config5_distance_mcmc"] = {
        "iters": n5 + n5 // 10,
        "accept_rate": round(float(diag5["accept_rate_glm"]), 3),
        "wall_s": round(time.time() - t0, 1),
        "note": "full 10k multi-chain run: scripts/rgc_flagship.py",
    }
    print("config 5 done", report["config5_distance_mcmc"], flush=True)

    os.makedirs(args.resultsDir, exist_ok=True)
    with open(os.path.join(args.resultsDir, "acceptance_report.json"), "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
