"""Model components — functional rebuild of ``pyglm/components/*``.

The reference models a GLM as a tree of ``Component`` objects, each holding
symbolic Theano variables, a symbolic log-prior, and numpy ``sample()``
(SURVEY.md §2 "Component base"). Here each component is a
:class:`CurrentComponent` record of three *pure functions* over a shared
params pytree:

  sample(key)          -> dict of this component's parameter leaves
  log_prior(params)    -> scalar log p(component params)
  current(params,data) -> (T, N) additive current for every neuron

The population sums currents, applies the nonlinearity, and adds the
observation log-likelihood (see models/population.py). All functions are
jit/vmap/grad-safe; there is no mutable state — the Theano shared-variable
``set_data`` dance becomes plain design tensors in the ``data`` dict.

Component catalog (reference parity, SURVEY.md §2):
  bias:    'constant'                     ≅ pyglm/components/bias.py
  bkgd:    'none' | 'basis' | 'spatiotemporal'  ≅ pyglm/components/bkgd.py
  impulse: 'basis' | 'normalized'         ≅ pyglm/components/impulse.py
  nlin:    'exp' | 'softplus'             ≅ pyglm/components/nlin.py
  observation: 'poisson' | 'bernoulli'    ≅ Poisson LL in pyglm/glm.py

Spec note: the reference's 'normalized' impulse puts a Dirichlet prior on
per-pair basis mixture weights so each coupling filter has unit area and the
network weight W carries the magnitude (identifiability; SURVEY.md §7). We
keep the unit-area softmax construction but use a *logistic-normal* prior
(iid Gaussian on the softmax logits) so the same parameters are HMC-friendly
without constrained-space moves; this is a documented spec choice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from theano_pyglm_tpu.ops.clipping import clip_exponent, exp_clipped
from theano_pyglm_tpu.ops.distributions import gaussian_logpdf
from theano_pyglm_tpu.utils.dtypes import default_float

__all__ = [
    "CurrentComponent",
    "make_bias",
    "make_bkgd",
    "make_impulse",
    "make_nlin",
    "make_observation",
]


class CurrentComponent(NamedTuple):
    name: str
    sample: Callable  # (key, N) -> dict of param leaves
    log_prior: Callable  # (params) -> scalar
    current: Callable  # (params, data) -> (T, N)
    effective: Callable = None  # impulse only: params -> (N, N, B) filter weights


def _zero_current(params, data):
    return jnp.zeros_like(data["S"])


# --- bias -----------------------------------------------------------------


def make_bias(spec: dict, N: int) -> CurrentComponent:
    """Constant bias current per neuron, Gaussian prior (≅ ConstantBias)."""
    mu, sigma = float(spec.get("mu", 2.0)), float(spec.get("sigma", 1.0))

    def sample(key):
        return {"bias": mu + sigma * jax.random.normal(key, (N,))}

    def log_prior(params):
        return jnp.sum(gaussian_logpdf(params["bias"], mu, sigma))

    def current(params, data):
        return jnp.broadcast_to(params["bias"][None, :], data["S"].shape)

    return CurrentComponent("bias", sample, log_prior, current)


# --- background / stimulus ------------------------------------------------


# Per-neuron gain prior of the shared-tuning background, N(mu, sd). Single
# source of truth: the Gibbs glm block (inference/gibbs.py,
# update_glm_laplace_shared) targets this exact conditional — a value
# duplicated there would silently change the sampled posterior if edited
# here alone.
GAIN_PRIOR_MU = 1.0
GAIN_PRIOR_SD = 0.3


def make_bkgd(spec: dict, N: int, B_stim: int, D_stim: int) -> CurrentComponent:
    """Stimulus-driven current (≅ pyglm/components/bkgd.py).

    'none':  no stimulus term.
    'basis': per-neuron weights over the (stim-dim × temporal-basis) design
             X_stim (T, D·B); I = X_stim @ w_stim.T — one matmul.
    'spatiotemporal': separable low-rank receptive field: per-neuron spatial
             weights w_stim_s (N, D) and temporal basis weights w_stim_t
             (N, B) contract the (T, D, B) design X_st:
             I[t,n] = Σ_d Σ_b w_s[n,d]·w_t[n,b]·X_st[t,d,b].
    """
    typ = spec.get("type", "none")
    mu, sigma = float(spec.get("mu", 0.0)), float(spec.get("sigma", 1.0))

    if typ == "none":
        return CurrentComponent(
            "bkgd", lambda key: {}, lambda params: jnp.asarray(0.0), _zero_current
        )

    if typ == "basis":
        DB = D_stim * B_stim

        def sample(key):
            return {"w_stim": mu + sigma * jax.random.normal(key, (N, DB))}

        def log_prior(params):
            return jnp.sum(gaussian_logpdf(params["w_stim"], mu, sigma))

        def current(params, data):
            return data["X_stim"] @ params["w_stim"].T  # (T,DB)@(DB,N)

        return CurrentComponent("bkgd", sample, log_prior, current)

    if typ == "shared":
        # Shared tuning curve with per-neuron gain (SURVEY.md §2 [L]):
        # one population-level temporal filter, each neuron scales it.
        DB = D_stim * B_stim

        def sample(key):
            k1, k2 = jax.random.split(key)
            return {
                "w_stim_shared": mu + sigma * jax.random.normal(k1, (DB,)),
                "gain": GAIN_PRIOR_MU + GAIN_PRIOR_SD * jax.random.normal(k2, (N,)),
            }

        def log_prior(params):
            return jnp.sum(gaussian_logpdf(params["w_stim_shared"], mu, sigma)) + jnp.sum(
                gaussian_logpdf(params["gain"], GAIN_PRIOR_MU, GAIN_PRIOR_SD)
            )

        def current(params, data):
            drive = data["X_stim"] @ params["w_stim_shared"]  # (T,)
            return drive[:, None] * params["gain"][None, :]

        return CurrentComponent("bkgd", sample, log_prior, current)

    if typ == "spatiotemporal":

        def sample(key):
            k1, k2 = jax.random.split(key)
            return {
                "w_stim_s": mu + sigma * jax.random.normal(k1, (N, D_stim)),
                "w_stim_t": mu + sigma * jax.random.normal(k2, (N, B_stim)),
            }

        def log_prior(params):
            return jnp.sum(gaussian_logpdf(params["w_stim_s"], mu, sigma)) + jnp.sum(
                gaussian_logpdf(params["w_stim_t"], mu, sigma)
            )

        def current(params, data):
            # (T,D,B),(N,D),(N,B) -> (T,N); XLA fuses into two matmuls.
            return jnp.einsum(
                "tdb,nd,nb->tn", data["X_st"], params["w_stim_s"], params["w_stim_t"]
            )

        return CurrentComponent("bkgd", sample, log_prior, current)

    raise ValueError(f"unknown bkgd type {typ!r}")


# --- impulse (spike-history / coupling filters) ---------------------------


def make_impulse(spec: dict, N: int, B_imp: int) -> CurrentComponent:
    """Coupling/spike-history filters (≅ pyglm/components/impulse.py).

    Parameter ``w_ir`` has shape (N_post, N_pre, B). The effective coupling
    current into postsynaptic neuron n is

        I_net[t, n] = Σ_pre G[n, pre] · (X_imp[t, pre, :] · w_eff[n, pre, :])

    where G = A∘W comes from the network component (population supplies it via
    ``data['_G']`` — see population.glm_currents) and X_imp (T, N, B) is the
    presynaptic spike design tensor.

    'basis':      w_eff = w_ir, iid Gaussian prior (coupling magnitude lives
                  in w_ir; used with constant weights).
    'normalized': w_eff = softmax(w_ir, axis=-1) — convex combination of
                  unit-sum basis columns ⇒ unit-sum filter, so W carries the
                  magnitude (identifiable (A, W); SURVEY.md §7). Logistic-
                  normal prior on the logits (spec choice, see module doc).
    """
    typ = spec.get("type", "basis")
    # mu may be scalar or per-basis-column (length-B list) — a per-column
    # mean biases normalized filters toward particular lags (e.g. fast,
    # early-peaked synaptic filters).
    mu = jnp.asarray(spec.get("mu", 0.0))
    sigma = jnp.asarray(spec.get("sigma", 1.0))

    def sample(key):
        return {"w_ir": mu + sigma * jax.random.normal(key, (N, N, B_imp))}

    def log_prior(params):
        return jnp.sum(gaussian_logpdf(params["w_ir"], mu, sigma))

    if typ == "basis":

        def effective(params):
            return params["w_ir"]

    elif typ == "normalized":

        def effective(params):
            return jax.nn.softmax(params["w_ir"], axis=-1)

    else:
        raise ValueError(f"unknown impulse type {typ!r}")

    def current(params, data):
        w_eff = effective(params)
        X = data["X_imp"]
        # ψ[t,p,n] = X_imp[t,p,:]·w_eff[n,p,:]; then weight by G[n,p] and sum.
        if X.dtype == jnp.bfloat16:
            # keep bf16 design tensors in bf16 with f32 accumulation
            # (upcasting the stream would forfeit the bandwidth win)
            I = jnp.einsum(
                "tpb,npb,np->tn", X, w_eff.astype(jnp.bfloat16),
                data["_G"].astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
        else:
            I = jnp.einsum("tpb,npb,np->tn", X, w_eff, data["_G"])
        mean = data.get("_X_imp_mean")
        if mean is not None:
            # the centered-out column means re-enter as a constant current
            I = I + jnp.einsum("pb,npb,np->n", mean, w_eff, data["_G"])[None, :]
        return I

    # ``effective`` is also used by simulate() and the collapsed-Gibbs A updates.
    return CurrentComponent("impulse", sample, log_prior, current, effective)


# --- nonlinearity ---------------------------------------------------------


class Nonlinearity(NamedTuple):
    name: str
    rate: Callable  # I -> λ  (spikes/s)
    log_rate: Callable  # I -> log λ  (stable form for the Poisson LL)


def make_nlin(spec: dict) -> Nonlinearity:
    """Rate nonlinearity (≅ pyglm/components/nlin.py): 'exp' or 'softplus'
    (the reference's soft-rectifying 'explinear', log(1+e^x))."""
    typ = spec.get("type", "exp")
    if typ == "exp":
        # The model is λ = exp(clip(I, ±EXP_CLIP)) — and log λ MUST be the
        # same clip(I), not raw I. With log_rate = I the Poisson LL
        # S·log λ − λ·dt grows LINEARLY in I beyond the clip on any spiking
        # bin (the rate cost freezes at e^40·dt while the S·I term keeps
        # rising): an unbounded degenerate direction that HMC/birth-death
        # excursions can ride to |W|~100 and a frozen chain (observed on a
        # flagship chain, round 2). Clipping both keeps the posterior
        # proper; within any plausible region the clamp is inactive and
        # 1e-6 parity holds. Spec + rationale: ops/clipping.py (the single
        # source of truth shared with the Gibbs fast paths and kernels).
        return Nonlinearity("exp", exp_clipped, clip_exponent)
    if typ in ("softplus", "explinear"):

        def rate(I):
            return jax.nn.softplus(I)

        def log_rate(I):
            # log(softplus(I)): for large I → log(I); for very negative I,
            # softplus(I) ≈ e^I so log ≈ I. Clamp to keep float32 finite.
            return jnp.log(jnp.clip(jax.nn.softplus(I), 1e-30, None))

        return Nonlinearity("softplus", rate, log_rate)
    raise ValueError(f"unknown nlin type {typ!r}")


# --- observation model ----------------------------------------------------


class Observation(NamedTuple):
    name: str
    log_likelihood: Callable  # (S, I, nlin, dt) -> (T, N) per-bin LL
    sample: Callable  # (key, rate, dt) -> spike counts, same shape as rate


def make_observation(spec: dict) -> Observation:
    """Per-bin spike likelihood (≅ the Poisson LL assembled in pyglm/glm.py;
    Bernoulli variant per SURVEY.md §2 [M]).

    Poisson:   S_t ~ Poisson(λ_t·dt);  LL = S·log(λdt) − λdt − log S!
               (full log-pmf incl. the constant, so values match
               scipy.stats.poisson exactly in verification mode).
    Bernoulli: S_t ∈ {0,1} = 1{≥1 spike}; p = 1 − exp(−λ·dt);
               LL = S·log(p) + (1−S)·(−λ·dt).
    """
    typ = spec.get("type", "poisson")
    if typ == "poisson":

        def ll(S, I, nlin, dt):
            log_rate = nlin.log_rate(I)
            rate = nlin.rate(I)
            # log S! is exactly 0 for S ∈ {0, 1}, nearly every bin; float32
            # lgamma(1) returns 4.8e-7, which over the 1.6 M bins of the
            # flagship would shift the log-joint by ~0.8.
            log_fact = jnp.where(S > 1.0, jax.scipy.special.gammaln(S + 1.0), 0.0)
            return S * (log_rate + jnp.log(dt)) - rate * dt - log_fact

        def sample(key, rate, dt):
            return jax.random.poisson(key, rate * dt).astype(default_float())

        return Observation("poisson", ll, sample)

    if typ == "bernoulli":

        def ll(S, I, nlin, dt):
            lam_dt = nlin.rate(I) * dt
            # log(1 − e^{−x}) computed stably via expm1.
            log_p = jnp.log(-jnp.expm1(-jnp.clip(lam_dt, 1e-10, None)))
            return S * log_p + (1.0 - S) * (-lam_dt)

        def sample(key, rate, dt):
            p = -jnp.expm1(-rate * dt)
            return jax.random.bernoulli(key, p).astype(default_float())

        return Observation("bernoulli", ll, sample)

    raise ValueError(f"unknown observation type {typ!r}")
