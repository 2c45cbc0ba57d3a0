"""Causal basis convolution — design-tensor construction.

Behavioral equivalent of ``convolve_with_basis`` in the reference's
``pyglm/utils/basis.py`` (SURVEY.md §2, §3.2): spike trains / stimuli are
convolved with each basis column once, up front, to produce fixed design
tensors that the (jitted) likelihood then contracts with learned weights.

Convention (documented spec, see SURVEY.md §7 "Identifiability conventions"):
the convolution is **strictly causal** —

    out[t, ..., b] = sum_{l=0}^{L-1} basis[l, b] * x[t - 1 - l]

so a spike in bin t can influence the rate from bin t+1 onward, never its own
bin (prevents instantaneous self-excitation in simulation and matches the
reference's spike-history semantics).

Implemented as a time-blocked im2col einsum: lag windows are materialized per
block (L static slices of a (C+L-1, N) chunk) and contracted against the
flipped basis. This is the exact same arithmetic as a direct convolution,
just reordered — NOT an approximation.

Why not ``lax.conv_general_dilated``: on the accelerator this library was
first built for, compiling a 1-D conv with spatial length ~60k and kernel
length 100–300 took minutes or never finished, while the blocked einsum
compiles quickly. Which of the two is better on the H100 is not measured
yet (ROADMAP).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from theano_pyglm_tpu.utils.dtypes import default_float

__all__ = ["convolve_with_basis", "upsample_stim"]


def convolve_with_basis(x: jax.Array, basis: jax.Array, block: int = 2048) -> jax.Array:
    """Strictly-causal convolution of signal(s) with basis columns.

    Args:
      x: signal, shape (T,) or (T, N) — e.g. spike counts or a 1-D stimulus.
      basis: (L, B) filter basis (rows = lags 1·dt … L·dt).
      block: time-block size for the im2col windows (peak extra memory is
        block·L·N floats; output correctness does not depend on it).

    Returns:
      (T, B) if x is (T,), else (T, N, B), with
      out[t, n, b] = Σ_l basis[l, b] · x[t-1-l, n] (zero-padded history).
    """
    x = jnp.asarray(x)
    basis = jnp.asarray(basis, dtype=x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else default_float())
    x = x.astype(basis.dtype)
    L, B = basis.shape
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    T, N = x.shape

    # out[t] = Σ_l basis[l]·x[t-1-l] = Σ_{l'} fb[l']·xp[t+l']  with
    # xp = [zeros(L); x] (so xp[i] = x[i-L]) and fb = flip(basis, lags):
    # substituting l' = L-1-l turns the causal sum into a plain correlation
    # against the zero-padded signal.
    fb = jnp.flip(basis, axis=0)  # (L, B)
    C = min(int(block), T)
    n_blocks = -(-T // C)
    target = n_blocks * C + L - 1
    xp = jnp.concatenate(
        [jnp.zeros((L, N), dtype=x.dtype), x,
         jnp.zeros((max(0, target - (T + L)), N), dtype=x.dtype)],
        axis=0,
    )

    def blk(t0):
        sl = lax.dynamic_slice_in_dim(xp, t0, C + L - 1)  # (C+L-1, N)
        windows = jnp.stack(
            [lax.slice_in_dim(sl, l, l + C) for l in range(L)]
        )  # (L, C, N): windows[l, c] = xp[t0+c+l]
        # HIGHEST keeps the contraction in true f32 (the design tensors feed
        # the 1e-6 oracle-parity path); this is a one-time/setup matmul.
        return jnp.einsum("lcn,lb->cnb", windows, fb,
                          precision=lax.Precision.HIGHEST)

    starts = jnp.arange(n_blocks, dtype=jnp.int32) * C
    if n_blocks == 1:
        out = blk(jnp.int32(0))  # (T≤C: no lax.map dispatch)
    else:
        out = lax.map(blk, starts).reshape(n_blocks * C, N, B)[:T]
    return out[:, 0, :] if squeeze else out


def upsample_stim(stim: jax.Array, dt_stim: float, dt: float, T: int) -> jax.Array:
    """Resample a stimulus from its own sampling interval to bin resolution.

    Reference parity: the reference's stimulus component interpolates the
    stimulus to spike-bin resolution in ``set_data`` (SURVEY.md §2
    "Background / stimulus"). Linear interpolation per stimulus dimension.

    Args:
      stim: (T_stim, D) or (T_stim,) stimulus at interval ``dt_stim``.
      dt_stim: stimulus frame interval (s).
      dt: spike-bin width (s).
      T: number of spike bins to produce.

    Returns:
      (T, D) (or (T,)) stimulus at bin resolution.
    """
    stim = jnp.asarray(stim)
    squeeze = stim.ndim == 1
    if squeeze:
        stim = stim[:, None]
    t_stim = jnp.arange(stim.shape[0]) * dt_stim
    t_bins = jnp.arange(T) * dt
    out = jax.vmap(lambda col: jnp.interp(t_bins, t_stim, col), in_axes=1, out_axes=1)(stim)
    return out[:, 0] if squeeze else out
