#!/usr/bin/env python
"""Probe: can a single fused design matmul close the gap between the full
log-joint value+grad (bench.py's headline) and the kernel-only coupling
floor?

Formulation B folds bias + stimulus + coupling into ONE MXU matmul:

    X_full = [X_imp.reshape(T, N·B) | X_stim | 1]   (T, M)   built once
    Theta  = [U ; w_stim.T ; (bias + mean·U)]        (M, N)   per eval
    I      = X_full @ Theta                                    one matmul
    LL     = Σ S∘clip(I) − dt·Σ e^clip(I)

value_and_grad then needs exactly two passes over X_full (forward matmul +
transposed cotangent matmul) — the same traffic as the kernel-only floor —
with every parameter gradient (bias, w_stim, w_ir via the softmax pullback,
W, A) recovered from dTheta by cheap small-tensor algebra that XLA fuses.

Run on a GPU:  python benchmarks/fused_design_probe.py [--bf16]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=27)
    ap.add_argument("--T", type=int, default=60_000)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from theano_pyglm_tpu import Population, make_model
    from theano_pyglm_tpu.inference.map import split_params
    from theano_pyglm_tpu.ops.clipping import clip_exponent
    from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    dd = jnp.bfloat16 if args.bf16 else None
    spec = make_model("distance_weighted_model", args.N)
    pop = Population(spec, design_dtype=dd)
    params = pop.sample(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    stim = rng.randn(args.T, 1).astype(np.float32)
    S = rng.poisson(0.02, size=(args.T, args.N)).astype(np.float32)
    data = pop.prepare_data(S, stim=stim)
    opt, frozen = split_params(params)
    N, B = pop.N, pop.B_imp
    T = args.T

    def timeit(fn, opt):
        @jax.jit
        def loop(o):
            def body(carry, _):
                val, grad = jax.value_and_grad(fn)(carry)
                return jax.tree.map(lambda c, g: c + 1e-9 * g, carry, grad), val

            return jax.lax.scan(body, o, None, length=args.iters)

        out = loop(opt)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = loop(opt)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        return args.iters / dt, float(out[1][-1])

    # --- A: current full log-joint path
    rate_a, val_a = timeit(lambda o: pop.log_joint({**frozen, **o}, data), opt)
    print(f"A current log_joint v&g:   {rate_a:8.1f} evals/s ({1e3/rate_a:.3f} ms)  val {val_a:.2f}")

    # --- B: fused single-matmul formulation (likelihood identical; priors added)
    Xs = data["X_stim"].astype(data["X_imp"].dtype)
    ones = jnp.ones((T, 1), data["X_imp"].dtype)
    X_full = jnp.concatenate(
        [data["X_imp"].reshape(T, N * B), Xs, ones], axis=1
    )  # (T, M)
    mean_flat = data["_X_imp_mean"].reshape(N * B)
    Sj = data["S"]
    dt_bin = pop.dt
    log_dt = float(np.log(dt_bin))
    const = -float(jnp.sum(
        jnp.where(Sj > 1.0, jax.scipy.special.gammaln(Sj + 1.0), 0.0)))

    def fused(o):
        p = {**frozen, **o}
        w_eff = pop.impulse.effective(p)  # (N, N, B)
        U = (w_eff * pop.coupling(p)[:, :, None]).transpose(1, 2, 0).reshape(N * B, N)
        bias_row = p["bias"] + mean_flat.astype(U.dtype) @ U
        Theta = jnp.concatenate([U, p["w_stim"].T, bias_row[None, :]], axis=0)
        I = X_full @ Theta.astype(X_full.dtype) if X_full.dtype == jnp.bfloat16 else X_full @ Theta
        if I.dtype != jnp.float32 and not jax.config.jax_enable_x64:
            I = I.astype(jnp.float32)
        Ic = clip_exponent(I)
        ll = jnp.sum(Sj * Ic) + log_dt * jnp.sum(Sj) - dt_bin * jnp.sum(jnp.exp(Ic)) + const
        return ll + pop.log_prior(p)

    rate_b, val_b = timeit(fused, opt)
    print(f"B fused single-matmul:     {rate_b:8.1f} evals/s ({1e3/rate_b:.3f} ms)  val {val_b:.2f}")
    print(f"  value agreement: rel delta {abs(val_b-val_a)/max(1.0,abs(val_a)):.2e}")

    # --- C: kernel-only floor (coupling matmul + Poisson reduce, no U assembly)
    U0 = jnp.asarray(rng.randn(N * B, N), jnp.float32)
    I_rest = jnp.asarray(rng.randn(1, N), jnp.float32)
    X_f = data["X_imp"].reshape(T, N * B)

    def kernel_only(u):
        I = I_rest + (X_f @ (u.astype(X_f.dtype) if X_f.dtype == jnp.bfloat16 else u))
        if I.dtype != jnp.float32 and not jax.config.jax_enable_x64:
            I = I.astype(jnp.float32)
        Ic = clip_exponent(I)
        return jnp.sum(Sj * Ic) - dt_bin * jnp.sum(jnp.exp(Ic))

    rate_c, _ = timeit(kernel_only, U0)
    print(f"C kernel-only floor:       {rate_c:8.1f} evals/s ({1e3/rate_c:.3f} ms)")

    # grad agreement A vs B
    import jax

    gA = jax.jit(jax.grad(lambda o: pop.log_joint({**frozen, **o}, data)))(opt)
    gB = jax.jit(jax.grad(fused))(opt)
    flat = lambda g: np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree.leaves(g)])
    fa, fb = flat(gA), flat(gB)
    print(f"  grad agreement: rel-L2 {np.linalg.norm(fb-fa)/max(1e-12,np.linalg.norm(fa)):.2e}")


if __name__ == "__main__":
    main()
