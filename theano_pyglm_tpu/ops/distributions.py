"""Log-densities and samplers for the prior/conjugate machinery.

Behavioral equivalent of the reference's symbolic prior helpers
(``pyglm/components/priors.py``, SURVEY.md §2 "Priors library") plus the
numpy sampling used by each component's ``sample()``. Here both directions are
pure JAX functions: ``*_logpdf(params | x)`` for use inside the jitted
log-joint, ``sample_*`` built on ``jax.random`` for prior draws and conjugate
Gibbs updates.

All log-pdfs are written directly in jnp (not jax.scipy wrappers) so the same
expressions run under float32 on the accelerator and float64 (``jax_enable_x64``) for the
1e-6 CPU verification mode (SURVEY.md §7 "Numerics").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln, xlogy

__all__ = [
    "gaussian_logpdf",
    "gamma_logpdf",
    "beta_logpdf",
    "dirichlet_logpdf",
    "bernoulli_logpmf",
    "categorical_logpmf",
    "poisson_logpmf",
    "sample_gaussian",
    "sample_gamma",
    "sample_beta",
    "sample_dirichlet",
    "sample_bernoulli",
    "sample_categorical",
]

_LOG2PI = 1.8378770664093453


def gaussian_logpdf(x, mu, sigma):
    """Elementwise N(x | mu, sigma²) log-density."""
    z = (x - mu) / sigma
    return -0.5 * (z * z + _LOG2PI) - jnp.log(sigma)


def gamma_logpdf(x, alpha, beta):
    """Gamma(shape=alpha, rate=beta) log-density."""
    return (
        xlogy(alpha, beta) - gammaln(alpha) + xlogy(alpha - 1.0, x) - beta * x
    )


def beta_logpdf(x, a, b):
    return (
        gammaln(a + b)
        - gammaln(a)
        - gammaln(b)
        + xlogy(a - 1.0, x)
        + xlogy(b - 1.0, 1.0 - x)
    )


def dirichlet_logpdf(x, alpha):
    """Dirichlet log-density; x, alpha: (..., K), reduces over the last axis."""
    return (
        gammaln(jnp.sum(alpha, -1))
        - jnp.sum(gammaln(alpha), -1)
        + jnp.sum(xlogy(alpha - 1.0, x), -1)
    )


def bernoulli_logpmf(k, p):
    """Numerically-safe Bernoulli log-pmf (p may hit 0/1 under hard priors)."""
    p = jnp.clip(p, 1e-12, 1.0 - 1e-12)
    return xlogy(k, p) + xlogy(1.0 - k, 1.0 - p)


def categorical_logpmf(k, log_pi):
    """k: int array (...,); log_pi: (..., K) normalized log-probabilities."""
    return jnp.take_along_axis(log_pi, k[..., None], axis=-1)[..., 0]


def poisson_logpmf(k, rate):
    """Poisson log-pmf for counts k with mean ``rate`` (= λ·dt in the GLM)."""
    return xlogy(k, rate) - rate - gammaln(k + 1.0)


# --- samplers -------------------------------------------------------------


def sample_gaussian(key, mu, sigma, shape=None):
    shape = jnp.broadcast_shapes(jnp.shape(mu), jnp.shape(sigma)) if shape is None else shape
    return mu + sigma * jax.random.normal(key, shape)


def sample_gamma(key, alpha, beta, shape=None):
    shape = jnp.shape(alpha) if shape is None else shape
    return jax.random.gamma(key, alpha, shape) / beta


def sample_beta(key, a, b, shape=None):
    shape = jnp.broadcast_shapes(jnp.shape(a), jnp.shape(b)) if shape is None else shape
    return jax.random.beta(key, a, b, shape)


def sample_dirichlet(key, alpha):
    return jax.random.dirichlet(key, alpha)


def sample_bernoulli(key, p, shape=None):
    shape = jnp.shape(p) if shape is None else shape
    return jax.random.bernoulli(key, p, shape).astype(jnp.float32)


def sample_categorical(key, log_pi, shape=()):
    return jax.random.categorical(key, log_pi, shape=shape)
