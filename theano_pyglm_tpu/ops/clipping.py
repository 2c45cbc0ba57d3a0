"""Single source of truth for the clipped-exp likelihood spec.

The model with the 'exp' nonlinearity is λ = exp(clip(I, ±EXP_CLIP)) with
log λ = clip(I, ±EXP_CLIP) — the clip applies to the COMBINED exponent
(bias + stimulus + coupling currents), never per-term. Rationale (round-2
flagship post-mortem, see models/components.make_nlin): with log λ = raw I
the Poisson log-likelihood S·log λ − λ·dt grows linearly in I beyond the
point where e^I overflows float32, creating an unbounded degenerate
direction that HMC/birth–death excursions can ride to |W| ≈ 100 and a
permanently-rejecting frozen chain. Clipping both λ and log λ at the same
point keeps the posterior proper and bounds every exponential at e^40, so
f32 reductions cannot produce inf − inf = NaN.

Within any physically plausible region (|I| < 40 ⇔ rates below
~2·10¹⁷ spikes/s at dt = 1 ms) the clamp is inactive and the likelihood is
exactly the textbook exp-Poisson GLM (1e-6 oracle parity holds there; the
saturated regime is oracle-tested too — tests/test_loglik.py).

Every code path that evaluates the exp-Poisson likelihood MUST use these
helpers (or EXP_CLIP itself): models/components.make_nlin,
inference/gibbs.py's birth–death fast path and Laplace blocks,
inference/ars.py.
A hand-duplicated constant that drifts desynchronizes the MH ratios from
the likelihood the HMC blocks sample — silently breaking exactness in the
saturated regime.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["EXP_CLIP", "clip_exponent", "exp_clipped", "exponent_active"]

EXP_CLIP = 40.0


def clip_exponent(I):
    """log λ for the clipped-exp model: clip(I, ±EXP_CLIP)."""
    return jnp.clip(I, -EXP_CLIP, EXP_CLIP)


def exp_clipped(I):
    """λ for the clipped-exp model: exp(clip(I, ±EXP_CLIP)) ≤ e^EXP_CLIP."""
    return jnp.exp(clip_exponent(I))


def exponent_active(I):
    """Boolean mask where the clamp is inactive (∂clip/∂I = 1)."""
    return jnp.abs(I) < EXP_CLIP
