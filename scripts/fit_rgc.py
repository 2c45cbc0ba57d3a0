#!/usr/bin/env python
"""Real-data fitting harness: .mat / event-file → bin → MAP + MCMC →
KS + held-out predictive report (SURVEY.md §2 "Harness scripts", §4.2).

The reference's RGC scripts load the Pillow 27-cell .mat, fit, and predict
held-out data [M]. This script accepts either
  - a Pillow-style .mat (SpTimes cell array + stim + dtStim; see
    utils/rgc.py for the format contract), or
  - an event-format .npz (spike_times/spike_neurons/N/T_sec/dt[, stim,
    stim_dt], as produced by utils/io.py),
bins events through the native C fast path, fits MAP then (optionally) full
MCMC, and writes a JSON report with per-neuron time-rescaling KS statistics
and held-out log-likelihoods.

No real RGC data ships offline; ``--make-fixture`` writes a synthetic
recording in the exact .mat format so the whole pipeline runs end-to-end:

    python scripts/fit_rgc.py --make-fixture /tmp/rgc_fixture.mat
    python scripts/fit_rgc.py --dataFile /tmp/rgc_fixture.mat
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataFile", "-d", type=str, default=None)
    ap.add_argument("--resultsDir", "-r", type=str, default="results/rgc")
    ap.add_argument("--model", "-m", type=str, default="sparse_weighted_model")
    ap.add_argument("--dt", type=float, default=1e-3, help="bin width (s)")
    ap.add_argument("--train_frac", type=float, default=0.8)
    ap.add_argument("--map_iters", type=int, default=500)
    ap.add_argument("--n_samples", type=int, default=200)
    ap.add_argument("--n_warmup", type=int, default=None)
    ap.add_argument("--skip-mcmc", action="store_true")
    ap.add_argument("--make-fixture", type=str, default=None, metavar="PATH",
                    help="write a synthetic Pillow-format .mat fixture and exit")
    ap.add_argument("--fixture-N", type=int, default=8)
    ap.add_argument("--fixture-T", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.make_fixture:
        from theano_pyglm_tpu.utils.rgc import save_rgc_fixture_mat

        save_rgc_fixture_mat(args.make_fixture, N=args.fixture_N,
                             T_sec=args.fixture_T, seed=args.seed)
        print(f"fixture written: {args.make_fixture}")
        return

    if not args.dataFile:
        ap.error("--dataFile required (or --make-fixture)")

    import jax

    from theano_pyglm_tpu import Population, make_model
    from theano_pyglm_tpu.inference import gibbs_sample, map_fit
    from theano_pyglm_tpu.inference.predictive import (
        map_heldout_log_likelihood,
        predictive_log_likelihood,
    )
    from theano_pyglm_tpu.inference.smart_init import smart_initialize
    from theano_pyglm_tpu.utils.binning import bin_spikes, native_available
    from theano_pyglm_tpu.utils.io import load_data, segment_data
    from theano_pyglm_tpu.utils.ks import time_rescaling_ks
    from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    # --- load + bin ---------------------------------------------------------
    t0 = time.time()
    ext = os.path.splitext(args.dataFile)[1].lower()
    if ext == ".mat":
        from theano_pyglm_tpu.utils.rgc import load_rgc_mat

        rec = load_rgc_mat(args.dataFile)
        N = int(rec["N"])
        T = int(round(rec["T_sec"] / args.dt))
        S = bin_spikes(rec["times"], rec["neurons"], T, args.dt, N)
        stim, stim_dt = rec.get("stim"), rec.get("stim_dt")
    else:
        rec = load_data(args.dataFile)
        S = np.asarray(rec["S"])
        N = S.shape[1]
        stim, stim_dt = rec.get("stim"), rec.get("stim_dt")
    print(f"loaded {args.dataFile}: N={N}, T={S.shape[0]} bins, "
          f"{int(S.sum())} spikes, native binner={native_available()}", flush=True)

    # --- model + split ------------------------------------------------------
    spec = make_model(args.model, N)
    if stim is None:
        spec["bkgd"] = {"type": "none"}
    pop = Population(spec)
    if stim is not None and stim_dt is not None and stim_dt != args.dt:
        from theano_pyglm_tpu.ops.convolve import upsample_stim

        stim = np.asarray(upsample_stim(np.asarray(stim, np.float64),
                                        float(stim_dt), args.dt, S.shape[0]))
    (S_tr, stim_tr), (S_ho, stim_ho) = segment_data(S, stim, args.train_frac)
    data_tr = pop.prepare_data(S_tr, stim=stim_tr)
    data_ho = pop.prepare_data(S_ho, stim=stim_ho)

    report = {"dataFile": args.dataFile, "N": N, "T_bins": int(S.shape[0]),
              "n_spikes": int(S.sum()), "model": args.model,
              "native_binner": bool(native_available())}

    # --- MAP ----------------------------------------------------------------
    init = smart_initialize(pop, data_tr)
    params_map, logp, iters = map_fit(pop, data_tr, init, max_iter=args.map_iters)
    ll_ho_map = float(map_heldout_log_likelihood(pop, params_map, data_ho))
    rates_ho = np.asarray(pop.nlin.rate(pop.total_current(params_map, data_ho)))
    ks, pv, _ = time_rescaling_ks(rates_ho, np.asarray(S_ho), pop.dt)
    # null comparison: a homogeneous-rate model (bias-only)
    null_rates = np.broadcast_to(np.asarray(S_tr).mean(0) / pop.dt, S_ho.shape)
    ks0, _, _ = time_rescaling_ks(null_rates, np.asarray(S_ho), pop.dt)
    report["map"] = {
        "log_joint_train": float(logp),
        "iters": int(iters),
        "heldout_loglik": ll_ho_map,
        "ks_mean": float(np.nanmean(ks)),
        "ks_per_neuron": [round(float(k), 4) for k in ks],
        "ks_null_mean": float(np.nanmean(ks0)),
        "ks_beats_null": bool(np.nanmean(ks) < np.nanmean(ks0)),
        "wall_s": round(time.time() - t0, 1),
    }
    print("MAP:", json.dumps(report["map"]), flush=True)

    # --- MCMC ----------------------------------------------------------------
    if not args.skip_mcmc:
        t0 = time.time()
        samples, diag, _ = gibbs_sample(
            pop, data_tr, jax.random.PRNGKey(args.seed), n_samples=args.n_samples,
            n_warmup=args.n_warmup, init_params=params_map,
            chunk_size=min(100, args.n_samples),
        )
        pll = float(predictive_log_likelihood(pop, samples, data_ho))
        post_mean_rates = np.zeros_like(rates_ho)
        take = np.linspace(0, args.n_samples - 1, min(32, args.n_samples)).astype(int)
        for i in take:
            p_i = {k: v[i] for k, v in samples.items()}
            post_mean_rates += np.asarray(pop.nlin.rate(pop.total_current(p_i, data_ho)))
        post_mean_rates /= len(take)
        ks_mcmc, _, _ = time_rescaling_ks(post_mean_rates, np.asarray(S_ho), pop.dt)
        report["mcmc"] = {
            "n_samples": args.n_samples,
            "accept_rate_glm": round(float(diag.get("accept_rate_glm", np.nan)), 3),
            "heldout_predictive_loglik": pll,
            "predictive_beats_map_point": bool(pll >= ll_ho_map),
            "ks_mean_posterior_rate": float(np.nanmean(ks_mcmc)),
            "wall_s": round(time.time() - t0, 1),
        }
        print("MCMC:", json.dumps(report["mcmc"]), flush=True)

    os.makedirs(args.resultsDir, exist_ok=True)
    out = os.path.join(args.resultsDir, "rgc_fit_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    np.savez_compressed(
        os.path.join(args.resultsDir, "rgc_fit_params.npz"),
        **{k: np.asarray(v) for k, v in params_map.items()},
    )
    print(f"report → {out}")


if __name__ == "__main__":
    main()
