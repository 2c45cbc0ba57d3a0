"""Spike-triggered averaging (≅ pyglm/utils/sta.py, SURVEY.md §2 "STA init").

Used by smart initialization to seed stimulus filters. Implemented as one
batched matmul over lagged stimulus windows, not a Python loop
over spikes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["sta"]


def sta(stim: jax.Array, S: jax.Array, L: int) -> jax.Array:
    """Spike-triggered average of the stimulus.

    Args:
      stim: (T, D) stimulus at bin resolution.
      S: (T, N) spike counts.
      L: number of history lags (the STA covers lags 1..L, strictly causal —
         same convention as ops.convolve).

    Returns:
      (N, L, D): for each neuron, the average stimulus in the L bins
      preceding a spike (lag 1 first).
    """
    stim = jnp.asarray(stim)
    S = jnp.asarray(S)
    if stim.ndim == 1:
        stim = stim[:, None]
    T, D = stim.shape

    # lagged[t, l, d] = stim[t - 1 - l, d]
    padded = jnp.concatenate([jnp.zeros((L, D), stim.dtype), stim], axis=0)
    idx = (jnp.arange(T)[:, None] + L - 1) - jnp.arange(L)[None, :]  # (T, L)
    lagged = padded[idx]  # (T, L, D)

    n_spikes = jnp.maximum(S.sum(axis=0), 1.0)  # (N,)
    out = jnp.einsum("tn,tld->nld", S, lagged) / n_spikes[:, None, None]
    return out
