"""Headline benchmark: Poisson loglik+grad evals/sec/chip on one GPU.

The workload is the flagship N=27 RGC-scale network GLM over T=60,000 bins
(60 s @ 1 ms, acceptance config 5's scale): one evaluation = the full
log-joint AND its gradient w.r.t. every continuous parameter (bias,
stimulus weights, impulse logits, coupling weights, locations) — the kernel
inside every HMC leapfrog step (SURVEY.md §3.4). It stops unless JAX's
first device is a GPU, and prints that device and the card's power limit.

By default it measures the library's default configuration (f32 design).
``--all`` also measures the bf16 design and prints its accuracy against the
f32 design (log-joint relative delta, gradient relative L2 error,
coupling-current relative L2 error).

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so the
stand-in baseline is the same computation implemented in single-threaded
numpy with hand-derived analytic gradients — a faithful proxy for the
reference's Theano-generated C/BLAS thunks on one CPU core.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"device", "card"}. ``--profile`` additionally captures a jax.profiler trace
of the measured configuration under results/profile/ (open with
TensorBoard/Perfetto).
"""

import argparse
import json
import sys
import time

import numpy as np


def build_problem(N=27, T=60_000, seed=0, design_dtype=None):
    import jax

    from theano_pyglm_tpu import Population, make_model
    from theano_pyglm_tpu.inference.map import split_params

    spec = make_model("distance_weighted_model", N)
    pop = Population(spec, design_dtype=design_dtype)
    params = pop.sample(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    stim = rng.randn(T, 1).astype(np.float32)
    # spikes need not be model-consistent for a throughput benchmark
    S = rng.poisson(0.02, size=(T, N)).astype(np.float32)
    data = pop.prepare_data(S, stim=stim)
    opt, frozen = split_params(params)
    return pop, opt, frozen, data


def bench_device(pop, opt, frozen, data, n_iters=200):
    """Device-side eval loop (lax.scan), exactly how HMC leapfrog consumes
    the kernel — host dispatch latency excluded, like the reference's timing
    of compiled Theano thunks inside scipy's optimizer loop."""
    import jax

    vg = jax.value_and_grad(lambda o: pop.log_joint({**frozen, **o}, data))

    @jax.jit
    def loop(opt):
        def body(carry, _):
            val, grad = vg(carry)
            # consume the gradient (mimics a leapfrog half-kick; defeats DCE)
            carry = jax.tree.map(lambda c, g: c + 1e-9 * g, carry, grad)
            return carry, val
        return jax.lax.scan(body, opt, None, length=n_iters)

    out = loop(opt)  # compile
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = loop(opt)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return n_iters / dt, float(out[1][-1]), loop


def bench_numpy(pop, opt, frozen, data, n_iters=3):
    """Single-threaded numpy loglik+grad (exp-Poisson closed forms)."""
    S = np.asarray(data["S"])
    X_stim = np.asarray(data["X_stim"])
    X_imp = np.asarray(data["X_imp"], dtype=np.float64).astype(np.float32)
    dt_bin = pop.dt
    A = np.asarray(frozen["A"])
    bias = np.asarray(opt["bias"])
    w_stim = np.asarray(opt["w_stim"])
    w_ir = np.asarray(opt["w_ir"])
    W = np.asarray(opt["W"])

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    t0 = time.perf_counter()
    for _ in range(n_iters):
        w_eff = softmax(w_ir)  # (N, N, B)
        G = A * W
        I = bias[None, :] + X_stim @ w_stim.T
        I = I + np.einsum("tpb,npb,np->tn", X_imp, w_eff, G, optimize=True)
        lam_dt = np.exp(I) * dt_bin
        # loglik
        ll = float((S * (I + np.log(dt_bin)) - lam_dt).sum())
        # gradient w.r.t. I, then chain rule to each parameter
        dI = S - lam_dt  # (T, N)
        g_bias = dI.sum(0)
        g_wstim = dI.T @ X_stim
        g_G = np.einsum("tn,tpb,npb->np", dI, X_imp, w_eff, optimize=True)
        g_W = g_G * A
        g_weff = np.einsum("tn,tpb,np->npb", dI, X_imp, G, optimize=True)
        g_wir = w_eff * (g_weff - (g_weff * w_eff).sum(-1, keepdims=True))
        _ = (ll, g_bias, g_wstim, g_W, g_wir)
    dt = time.perf_counter() - t0
    return n_iters / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="capture a jax.profiler trace of the measured config")
    ap.add_argument("--all", action="store_true",
                    help="also measure the bf16 design and report its "
                         "accuracy against the f32 design")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache
    from theano_pyglm_tpu.utils.device import describe_gpu

    card = describe_gpu(emit=lambda line: print(line, file=sys.stderr))
    enable_compile_cache()
    dev = jax.devices()

    candidates = [("xla_f32", dict(design_dtype=None))]
    if args.all:
        candidates += [("xla_bf16", dict(design_dtype=jnp.bfloat16))]

    results, vals, loops = {}, {}, {}
    for name, kw in candidates:
        pop, opt, frozen, data = build_problem(**kw)
        rate, val, loop = bench_device(pop, opt, frozen, data)
        results[name], vals[name], loops[name] = rate, val, (loop, opt)
        print(f"  {name}: {rate:.1f} evals/s (val {val:.2f}) [{card}]",
              file=sys.stderr)

    best = max(results, key=results.get)
    if args.all and "xla_f32" in vals:
        # bf16-design accuracy: log-joint relative delta, gradient relative
        # L2 error, coupling-current relative L2 error — all at the same
        # parameter point, bf16-design vs f32-design.
        pop_f, opt_f, frozen_f, data_f = build_problem(design_dtype=None)
        pop_b, _, _, data_b = build_problem(design_dtype=jnp.bfloat16)
        vg = lambda pp, dd: jax.value_and_grad(
            lambda o: pp.log_joint({**frozen_f, **o}, dd)
        )(opt_f)
        v_f, g_f = jax.jit(lambda: vg(pop_f, data_f))()
        v_b, g_b = jax.jit(lambda: vg(pop_b, data_b))()
        d_val = abs(float(v_b) - float(v_f)) / max(1.0, abs(float(v_f)))
        flat = lambda g: np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree.leaves(g)])
        gf, gb = flat(g_f), flat(g_b)
        d_grad = float(np.linalg.norm(gb - gf) / max(1e-12, np.linalg.norm(gf)))
        d_f = dict(data_f); d_f["_G"] = pop_f.coupling(opt_f | frozen_f)
        d_b = dict(data_b); d_b["_G"] = d_f["_G"]
        I_f = np.asarray(pop_f.impulse.current({**frozen_f, **opt_f}, d_f))
        I_b = np.asarray(pop_b.impulse.current({**frozen_f, **opt_f}, d_b))
        d_cur = float(np.linalg.norm(I_b - I_f) / max(1e-12, np.linalg.norm(I_f)))
        print(
            f"  bf16-design accuracy vs f32: log-joint rel {d_val:.2e}, "
            f"grad rel-L2 {d_grad:.2e}, coupling-current rel-L2 {d_cur:.2e}",
            file=sys.stderr,
        )

    if args.profile:
        import os

        os.makedirs("results/profile", exist_ok=True)
        loop, opt = loops[best]
        with jax.profiler.trace("results/profile"):
            jax.block_until_ready(loop(opt))
        print("  trace → results/profile/", file=sys.stderr)

    # keep the CPU baseline on one thread to mimic the reference's setting;
    # the baseline always evaluates the f32 design (the reference has no bf16)
    pop, opt, frozen, data = build_problem(design_dtype=None)
    try:
        import threadpoolctl

        ctx = threadpoolctl.threadpool_limits(1)
    except Exception:
        ctx = None
    numpy_evals_per_sec = bench_numpy(pop, opt, frozen, data)
    print(
        json.dumps(
            {
                "metric": "poisson_loglik_grad_evals_per_sec_per_chip_N27_T60k",
                "value": round(results[best], 3),
                "unit": "evals/s",
                "vs_baseline": round(results[best] / numpy_evals_per_sec, 2),
                "device": {"platform": dev[0].platform,
                           "kind": dev[0].device_kind, "count": len(dev)},
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    main()
