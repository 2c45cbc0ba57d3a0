#!/usr/bin/env python
"""Long-recording stretch run: N=100 neurons, T=600,000 bins (10 min @ 1 ms).

Demonstrates the SURVEY.md §5 long-context machinery at a scale that needs
it (round-3 verdict #6):

  * the full unit-coupling tensor ψ is (T, N, N) = 24 GB, so the adjacency
    birth–death sweep streams ψ one postsynaptic-row batch at a time
    (``row_batch``; one row is 240 MB). ``row_batch=4`` is the value chosen
    for a 16 GB device; sizing it from the card's memory is ROADMAP S6;
  * MAP runs with ``materialize_design=False`` + ``time_chunk``: the
    (T, N, B) spike design (1.2 GB here, unbounded in general) is never
    materialized — each time block rebuilds its design from the spikes with
    an exact L-bin causal halo, and ``jax.checkpoint`` keeps the VJP's
    working set to one block;
  * MCMC runs in chunks of about 18 s of device time (a one-sweep probe
    picks the chunk size): a checkpoint is written per chunk, so a crash
    loses at most one chunk. The 18 s target is inherited; ROADMAP S2
    sizes it from measurement.

Emits results/<dir>/stretch_report.json with wall clocks, ms/sweep,
acceptance rates, link-prediction AUC vs the generating network, and Geyer
ESS on the connected weights.

  python scripts/stretch_streaming.py [--quick]   # --quick: CPU smoke sizes
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
    ap.add_argument("--resultsDir", "-r", default="results/stretch")
    ap.add_argument("--n_warmup", type=int, default=150)
    ap.add_argument("--n_samples", type=int, default=300)
    ap.add_argument(
        "--chunk_size", type=int, default=25,
        help="max sweeps per device chunk; auto-reduced by the sweep probe",
    )
    ap.add_argument(
        "--no_probe", action="store_true",
        help="skip the sweep-time probe and trust --chunk_size (use on a "
        "resume, with the chunk size the first attempt's probe chose, so "
        "the probe's compiles are not paid twice)",
    )
    args = ap.parse_args()
    q = args.quick

    import jax
    import jax.numpy as jnp

    from theano_pyglm_tpu import Population, make_model
    from theano_pyglm_tpu.inference import gibbs_sample, map_fit
    from theano_pyglm_tpu.inference.smart_init import smart_initialize
    from theano_pyglm_tpu.utils.diagnostics import ess
    from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    N = 10 if q else 100
    T = 6_000 if q else 600_000
    report = {"N": N, "T": T}
    report["psi_full_gb"] = round(T * N * N * 4 / 1e9, 1)
    report["x_imp_gb"] = round(T * N * 5 * 4 / 1e9, 2)

    # Identifiable planted coupling (the acceptance config-2 recipe, balanced
    # so the N=100 in-degree does not produce runaway excitation): edges from
    # the ER prior draw, weights ±1.5 with equal sign probability, inhibitory
    # self-coupling.
    spec = make_model("sparse_weighted_model", N)
    spec["bias"] = {"mu": 2.3, "sigma": 0.3}
    pop = Population(spec)
    true = dict(pop.sample(jax.random.PRNGKey(0)))
    rngw = np.random.RandomState(1)
    Wp = np.where(rngw.rand(N, N) < 0.5, 1.5, -1.5).astype(np.float32)
    np.fill_diagonal(Wp, -2.0)
    true["W"] = jnp.asarray(Wp) * true["A"]

    rng = np.random.RandomState(2)
    stim = rng.randn(T, 1).astype(np.float32)
    t0 = time.time()
    S, rates = pop.simulate(jax.random.PRNGKey(3), true, T, stim=stim)
    jax.block_until_ready(S)
    report["simulate_s"] = round(time.time() - t0, 1)
    report["mean_rate_hz"] = round(float(np.asarray(rates).mean()), 2)
    report["spikes"] = int(np.asarray(S).sum())
    print(f"simulated: {report}", flush=True)

    # ---- MAP, fully streaming: design never materialized ------------------
    t0 = time.time()
    chunk = 2_000 if q else 65_536
    pop_stream = Population(spec, time_chunk=chunk)
    data_stream = pop_stream.prepare_data(S, stim=stim, materialize_design=False)
    init = smart_initialize(pop_stream, data_stream)
    init["A"] = jnp.ones((N, N))
    fit, logp, iters = map_fit(pop_stream, data_stream, init)
    report["map_streaming"] = {
        "log_joint": float(logp),
        "log_joint_at_truth": float(pop_stream.log_joint(true, data_stream)),
        "iters": int(iters),
        "wall_s": round(time.time() - t0, 1),
        "time_chunk": chunk,
    }
    print(f"MAP done: {report['map_streaming']}", flush=True)

    # ---- MCMC: materialized basis design (1.2 GB), ψ row-streamed ---------
    data = pop.prepare_data(S, stim=stim)
    row_batch = 2 if q else 4
    n_w, n_s = (20, 30) if q else (args.n_warmup, args.n_samples)
    cap = 10 if q else args.chunk_size
    if args.no_probe:
        chunk_size = cap
    else:
        # Probe one sweep's wall clock and size chunks to ~18 s of device
        # time each (see the module docstring). One 5-sweep call,
        # chunk_size=1; the first sample
        # chunk pays the n=1 compile, so steady state is the median of the
        # later chunk-to-chunk gaps (a separate warm *call* would re-trace:
        # make_sweep builds fresh closures per call, defeating the jit cache).
        ticks = []
        t0 = time.time()
        gibbs_sample(
            pop, data, jax.random.PRNGKey(99),
            n_samples=4, n_warmup=1, thin=1, chunk_size=1,
            init_params=dict(fit), row_batch=row_batch,
            callback=lambda phase, it, st: ticks.append((phase, time.time())),
        )
        probe_cold = time.time() - t0
        gaps = [b - a for (pa, a), (pb, b) in zip(ticks, ticks[1:]) if pa == pb == "sample"]
        sweep_s = sorted(gaps)[len(gaps) // 2]
        chunk_size = max(1, min(cap, int(18.0 / max(sweep_s, 1e-3))))
        report["sweep_probe"] = {
            "cold_5sweeps_s": round(probe_cold, 1),
            "warm_s_per_sweep": round(sweep_s, 2),
            "chosen_chunk_size": chunk_size,
        }
        print(f"sweep probe: {report['sweep_probe']}", flush=True)

    # Checkpoint + resume: a crashed attempt resumes from the last completed
    # chunk instead of re-paying simulate/MAP/warmup. Resume requires the
    # same chunk layout: pass --no_probe --chunk_size <chosen> on the retry.
    t0 = time.time()
    main_ticks = []
    samples, diag, _ = gibbs_sample(
        pop, data, jax.random.PRNGKey(4),
        n_samples=n_s, n_warmup=n_w, thin=1,
        chunk_size=chunk_size,
        init_params=dict(fit),
        row_batch=row_batch,
        checkpoint_dir=os.path.join(args.resultsDir, "ckpt"),
        resume=True,
        callback=lambda phase, it, st: main_ticks.append((phase, it, time.time())),
    )
    wall = time.time() - t0
    # steady-state ms/sweep from the chunk-end gaps (first chunk of each
    # phase pays that phase's XLA compile; the median gap is post-compile)
    steady = {}
    for ph in ("warmup", "sample"):
        gaps = [
            (t1 - t0_) / (i1 - i0)
            for (p0, i0, t0_), (p1, i1, t1) in zip(main_ticks, main_ticks[1:])
            if p0 == p1 == ph and i1 > i0
        ]
        if gaps:
            steady[ph] = sorted(gaps)[len(gaps) // 2]
    half = n_s // 2
    A_post = np.asarray(samples["A"][half:]).mean(axis=0)
    A_true = np.asarray(true["A"])
    off = ~np.eye(N, dtype=bool)
    th = np.sort(np.unique(A_post[off]))[::-1]
    tpr = [(A_post[off][A_true[off] == 1] >= t).mean() for t in th]
    fpr = [(A_post[off][A_true[off] == 0] >= t).mean() for t in th]
    auc = float(np.trapezoid(tpr, fpr))
    W_post = np.asarray(samples["W"][half:]).mean(axis=0)
    conn = (A_true > 0) & off
    w_err = float(np.abs((W_post - np.asarray(true["W"]))[conn]).mean())
    # Geyer ESS on the connected weights' chains (tail half)
    W_tail = np.asarray(samples["W"][half:])[:, conn]  # (half, n_edges)
    W_sub = W_tail[:, :: max(1, W_tail.shape[1] // 200)]  # subsample edges
    ess_vals = ess(W_sub[:, None, :])  # (n, 1 chain, p)
    report["mcmc"] = {
        "n_warmup": n_w,
        "n_samples": n_s,
        "row_batch": row_batch,
        "chunk_size": chunk_size,
        "ms_per_sweep": round(wall / (n_w + n_s) * 1e3, 1),
        "ms_per_sweep_steady": {
            ph: round(v * 1e3, 1) for ph, v in steady.items()
        },
        "wall_s": round(wall, 1),
        "accept_rate_glm": round(float(np.asarray(diag["accept_rate_glm"])), 3),
        "accept_rate_imp": round(float(np.asarray(diag["accept_rate_imp"])), 3),
        "link_prediction_auc": round(auc, 3),
        "W_mean_abs_err_connected": round(w_err, 3),
        "ess_W_median": round(float(np.median(ess_vals)), 1),
        "ess_W_min": round(float(np.min(ess_vals)), 1),
    }
    print(f"MCMC done: {report['mcmc']}", flush=True)

    os.makedirs(args.resultsDir, exist_ok=True)
    with open(os.path.join(args.resultsDir, "stretch_report.json"), "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
