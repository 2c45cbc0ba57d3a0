"""MAP inference — L-BFGS on the jitted log-joint.

Rebuild of the reference's coordinate-descent MAP path
(``pyglm/inference/coord_descent.py``, SURVEY.md §2, §3.2). The reference
alternates scipy ``fmin_l_bfgs_b`` over (a) per-neuron GLM variables and (b)
global network variables, each through packed vectors and compiled Theano
thunks. Under XLA both structures collapse: the likelihood factorizes over
postsynaptic neurons and the priors are separable, so one joint L-BFGS run on
the full continuous parameter block *is* the per-neuron coordinate sweep —
the gradient blocks are independent — and it runs as one fused XLA program
with no pack/unpack host round-trips (pytrees replace ``packvec``,
SURVEY.md §2 "Pack/unpack").

Sparse network MAP (acceptance config 2) follows the reference's
"sparse coupling + cross-validated λ" recipe: an L1 penalty on the off-
diagonal coupling weights (smoothed as √(w²+ε²) so L-BFGS applies), with λ
chosen by held-out predictive log-likelihood via :func:`cross_validate_lambda`.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import optax

__all__ = [
    "CONTINUOUS_KEYS",
    "map_fit",
    "sparse_map_fit",
    "cross_validate_lambda",
    "lbfgs_minimize",
]

# Continuous, unconstrained leaves MAP (and HMC) may move. Discrete latents
# (A, y) and conjugate hypers (pi, Bm, rho) are handled by the Gibbs machinery.
CONTINUOUS_KEYS = ("bias", "w_stim", "w_stim_s", "w_stim_t", "w_stim_shared", "gain", "w_ir", "W", "locs")


def split_params(params: dict, keys: Sequence[str] = CONTINUOUS_KEYS):
    """Partition a params dict into (optimized, frozen) sub-dicts by key."""
    opt = {k: v for k, v in params.items() if k in keys}
    frozen = {k: v for k, v in params.items() if k not in keys}
    return opt, frozen


def lbfgs_minimize(fun, x0, max_iter: int = 500, tol: float = 1e-6):
    """Minimize ``fun`` (pytree -> scalar) with optax L-BFGS + zoom linesearch.

    The whole optimization loop runs device-side under ``lax.while_loop`` —
    the device-side replacement for the reference's scipy
    ``fmin_l_bfgs_b`` calls.
    Returns (x_opt, final_value, n_iters).
    """
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(fun)

    def cond(carry):
        _, state, prev_val, it = carry
        val = optax.tree.get(state, "value")
        grad = optax.tree.get(state, "grad")
        gnorm = optax.tree.norm(grad)
        progress = jnp.abs(val - prev_val) > tol * (1.0 + jnp.abs(val))
        return (it < max_iter) & ((it < 2) | (progress & (gnorm > tol)))

    def body(carry):
        x, state, _, it = carry
        val, grad = value_and_grad(x, state=state)
        updates, state = opt.update(grad, state, x, value=val, grad=grad, value_fn=fun)
        x = optax.apply_updates(x, updates)
        return x, state, val, it + 1

    state0 = opt.init(x0)
    x, state, _, iters = jax.lax.while_loop(
        cond, body, (x0, state0, jnp.asarray(jnp.inf), jnp.asarray(0))
    )
    return x, optax.tree.get(state, "value"), iters


@partial(jax.jit, static_argnums=(0, 3, 6))
def _map_fit_jit(pop, params0, data, max_iter, lam, l1_eps, penalize_W):
    opt0, frozen = split_params(params0)

    def objective(opt_params):
        p = {**frozen, **opt_params}
        nlp = -pop.log_joint(p, data)
        if penalize_W:
            W = opt_params["W"]
            off = W * (1.0 - jnp.eye(W.shape[0]))
            nlp = nlp + lam * jnp.sum(jnp.sqrt(off * off + l1_eps * l1_eps))
        return nlp

    opt, val, iters = lbfgs_minimize(objective, opt0, max_iter=max_iter)
    return {**frozen, **opt}, -val, iters


def map_fit(pop, data, init_params, max_iter: int = 500):
    """MAP-fit all continuous parameters (discrete latents held fixed).

    ≅ ``coord_descent(population, data, x0)`` for the dense-network case.
    Returns (params_map, log_joint_at_map, n_iterations).
    """
    params, logp, iters = _map_fit_jit(pop, init_params, data, max_iter, 0.0, 1e-6, False)
    return params, logp, iters


def sparse_map_fit(pop, data, init_params, lam: float, max_iter: int = 500, l1_eps: float = 1e-6):
    """MAP with an L1 (lasso) penalty λ·Σ|W_offdiag| for sparse coupling.

    ≅ the reference's sparse-network MAP (acceptance config 2). The penalty is
    smoothed (√(w²+ε²)) so the same L-BFGS path applies; with ε=1e-6 the
    minimizer's support is recovered by thresholding |W| at ~√ε.
    """
    from theano_pyglm_tpu.utils.dtypes import default_float as _df
    lam = jnp.asarray(lam, _df())
    params, logp, iters = _map_fit_jit(pop, init_params, data, max_iter, lam, l1_eps, True)
    return params, logp, iters


def heldout_log_likelihood(pop, params, data):
    return pop.log_likelihood(params, data)


@partial(jax.jit, static_argnums=(0, 3, 6))
def _map_fit_multi_jit(pop, params0, datas, max_iter, lam, l1_eps, penalize_W):
    """MAP over a *tuple* of data segments: the spike LL is additive over
    disjoint time segments (each segment's design gets its own zero-padded
    causal history, so no seam artifacts), the prior enters once."""
    opt0, frozen = split_params(params0)

    def objective(opt_params):
        p = {**frozen, **opt_params}
        nlp = -pop.log_prior(p)
        for d in datas:
            nlp = nlp - pop.log_likelihood(p, d)
        if penalize_W:
            W = opt_params["W"]
            off = W * (1.0 - jnp.eye(W.shape[0]))
            nlp = nlp + lam * jnp.sum(jnp.sqrt(off * off + l1_eps * l1_eps))
        return nlp

    opt, val, iters = lbfgs_minimize(objective, opt0, max_iter=max_iter)
    return {**frozen, **opt}, -val, iters


def cross_validate_lambda(
    pop,
    S,
    stim,
    init_params,
    lambdas: Sequence[float],
    train_frac: float = 0.8,
    max_iter: int = 300,
    n_folds: int = 1,
    warm_start: bool = True,
):
    """Grid-search the sparsity penalty λ by held-out predictive log-lik.

    ≅ the reference's xv harness (SURVEY.md §3.5). ``n_folds=1`` is the
    reference's single contiguous train/validation split; ``n_folds>1`` runs
    contiguous-block k-fold (validation block rotates, training happens on
    the remaining segments, whose likelihoods add — each segment keeps its
    own causal design so fold seams are exact). λ's are fitted
    smallest-first with warm starts: each fit initializes from the previous
    (denser) λ's solution. Ascending order matters because the joint
    objective is nonconvex (impulse filters co-adapt): descending order can
    warm-start every fit from an all-zero-coupling solution whose filters
    have adapted to no coupling, and the path never escapes it.

    Returns (best_lambda, fits, scores): ``fits`` are fold-0 fits per λ,
    ``scores`` the mean held-out log-lik per λ (same order as ``lambdas``).
    """
    T = S.shape[0]
    if n_folds <= 1:
        T_tr = int(T * train_frac)
        folds = [((slice(0, T_tr),), slice(T_tr, T))]
    else:
        edges = [int(round(i * T / n_folds)) for i in range(n_folds + 1)]
        folds = []
        for i in range(n_folds):
            val = slice(edges[i], edges[i + 1])
            train = tuple(
                s for s in (slice(0, edges[i]), slice(edges[i + 1], T))
                if s.stop > s.start
            )
            folds.append((train, val))

    def seg_data(sl):
        return pop.prepare_data(
            S[sl], stim=None if stim is None else stim[sl]
        )

    order = sorted(range(len(lambdas)), key=lambda i: float(lambdas[i]))
    scores_sum = [0.0] * len(lambdas)
    fits_fold0 = [None] * len(lambdas)
    for fold_i, (train_sls, val_sl) in enumerate(folds):
        datas = tuple(seg_data(sl) for sl in train_sls)
        data_val = seg_data(val_sl)
        # Each fold's λ path MUST start from the fold-independent
        # init_params: warm-starting fold i+1 from fold i's final fit would
        # leak fold i+1's validation block (part of fold i's training data)
        # into the initialization of the very fits being scored on it —
        # and the nonconvex objective makes the solution basin
        # initialization-dependent. Warm starts apply within a fold only.
        params = init_params
        for i in order:
            fit, _, _ = _map_fit_multi_jit(
                pop, params, datas, max_iter,
                jnp.asarray(float(lambdas[i])), 1e-6, True,
            )
            if warm_start:
                params = fit
            scores_sum[i] += float(pop.log_likelihood(fit, data_val))
            if fold_i == 0:
                fits_fold0[i] = fit
    scores = [s / len(folds) for s in scores_sum]
    best = int(jnp.argmax(jnp.asarray(scores)))
    return lambdas[best], fits_fold0, scores
