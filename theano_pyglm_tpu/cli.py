"""Harness entry points (≅ the reference's ``test/`` scripts, SURVEY.md §1
layer L6 / §3): synthetic data generation, MAP fitting, full MCMC — each a
function callable from the ``scripts/`` wrappers or programmatically.

  generate_synth_data: make_model → sample → simulate → save  (≅ §3.1)
  fit_map:             load → smart init → (sparse/xv) MAP → save (≅ §3.2)
  fit_mcmc:            load → gibbs_sample[_chains] → save       (≅ §3.3)
"""

from __future__ import annotations

import os

import jax
import numpy as np

from theano_pyglm_tpu import Population, make_model
from theano_pyglm_tpu.inference import cross_validate_lambda, gibbs_sample, map_fit, sparse_map_fit
from theano_pyglm_tpu.inference.smart_init import smart_initialize
from theano_pyglm_tpu.parallel import gibbs_sample_chains
from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache
from theano_pyglm_tpu.utils.io import load_data, parse_cmd_line_args, save_results
from theano_pyglm_tpu.utils.metrics import MetricsWriter, timer

__all__ = ["generate_synth_data", "fit_map", "fit_mcmc", "main"]


def _build_population(args, data=None):
    N = int(data["S"].shape[1]) if data is not None else args.N
    spec = make_model(args.model, N)
    if args.dt:
        spec["dt"] = args.dt
    return Population(spec)


def generate_synth_data(args):
    """≅ test/generate_synth_data.py (SURVEY.md §3.1)."""
    pop = _build_population(args)
    key = jax.random.PRNGKey(args.seed)
    k1, k2, k3 = jax.random.split(key, 3)
    params = pop.sample(k1)
    T = int(round(args.T / pop.dt))
    stim = None
    if pop.basis_stim is not None:
        D = pop.D_stim
        stim = np.asarray(jax.random.normal(k2, (T, D)), dtype=np.float32)
    with timer("simulate", echo=True):
        S, rates = pop.simulate(k3, params, T, stim=stim)
    out = os.path.join(args.resultsDir, "synth_data.npz")
    payload = {
        "S": np.asarray(S),
        "dt": pop.dt,
        "model": args.model,
        "true_params": {k: np.asarray(v) for k, v in params.items()},
    }
    if stim is not None:
        payload["stim"] = stim
    save_results(out, payload)
    print(
        f"generated {float(np.asarray(S).sum()):.0f} spikes over {args.T:.0f}s, "
        f"N={pop.N}, mean rate {float(np.asarray(rates).mean()):.2f} Hz -> {out}"
    )
    return out


def _load_problem(args):
    raw = load_data(args.dataFile)
    pop = _build_population(args, raw)
    stim = raw.get("stim")
    data = pop.prepare_data(raw["S"], stim=stim)
    return pop, data, raw


def fit_map(args):
    """≅ test/synth_map.py (+ sparse/xv variants, SURVEY.md §3.2/§3.5)."""
    pop, data, raw = _load_problem(args)
    init = smart_initialize(pop, data)
    with timer("map", echo=True):
        if args.xv:
            lambdas = [0.1, 1.0, 10.0, 100.0]
            best, fits, scores = cross_validate_lambda(
                pop, data["S"], raw.get("stim"), init, lambdas
            )
            print(f"xv: best lambda={best} scores={scores}")
            params, logp, iters = sparse_map_fit(pop, data, init, best)
        elif args.lam is not None:
            params, logp, iters = sparse_map_fit(pop, data, init, args.lam)
        else:
            params, logp, iters = map_fit(pop, data, init)
    out = os.path.join(args.resultsDir, "map_results.npz")
    save_results(
        out,
        {
            "params": {k: np.asarray(v) for k, v in params.items()},
            "log_joint": float(logp),
            "iters": int(iters),
        },
    )
    print(f"MAP log-joint {float(logp):.3f} in {int(iters)} iters -> {out}")
    try:
        from theano_pyglm_tpu.plotting import plot_results

        truth = raw.get("true_params")
        plot_results(pop, params, truth, data, os.path.join(args.resultsDir, "map_results.png"))
    except Exception as e:  # plotting is best-effort in headless harnesses
        print(f"(plotting skipped: {e})")
    return out


def fit_mcmc(args):
    """≅ test/synth_mcmc.py (+ parallel chains, SURVEY.md §3.3)."""
    pop, data, raw = _load_problem(args)
    init = smart_initialize(pop, data)
    metrics = MetricsWriter(os.path.join(args.resultsDir, "mcmc_metrics.jsonl"))

    def cb(phase, it, state):
        metrics.log(
            it,
            phase=phase,
            accept=float(np.mean(np.asarray(state["glm"].accept_rate))),
            step_size=float(np.mean(np.asarray(state["glm"].step_size))),
        )

    key = jax.random.PRNGKey(args.seed)
    with timer("mcmc", echo=True):
        if args.n_chains > 1:
            samples, diag, _ = gibbs_sample_chains(
                pop, data, key,
                n_chains=args.n_chains, n_samples=args.n_samples,
                n_warmup=args.n_warmup, init_params=init, callback=cb,
            )
        else:
            samples, diag, _ = gibbs_sample(
                pop, data, key,
                n_samples=args.n_samples, n_warmup=args.n_warmup,
                init_params=init, callback=cb,
                checkpoint_dir=os.path.join(args.resultsDir, "checkpoints"),
                checkpoint_every=args.checkpoint_every,
                resume=args.resume,
            )
    metrics.close()
    out = os.path.join(args.resultsDir, "mcmc_samples.npz")
    save_results(out, {"samples": samples, "diagnostics": {
        k: v for k, v in diag.items() if not isinstance(v, dict)
    }})
    print(f"MCMC done: {args.n_samples} samples -> {out}")
    print(f"diagnostics: {diag}")
    return out


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("generate", "map", "mcmc"):
        print("usage: python -m theano_pyglm_tpu.cli {generate|map|mcmc} [flags]")
        return 2
    cmd, rest = argv[0], argv[1:]
    args = parse_cmd_line_args(rest)
    enable_compile_cache()
    if cmd == "generate":
        return generate_synth_data(args)
    if cmd == "map":
        return fit_map(args)
    return fit_mcmc(args)


if __name__ == "__main__":
    main()
