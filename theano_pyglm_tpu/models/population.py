"""Population model — N coupled GLMs plus a network prior.

Functional rebuild of ``pyglm/glm.py`` + ``pyglm/population.py`` (SURVEY.md
§2, §3.4). Where the reference builds one symbolic Theano graph per neuron
(re-seated via a shared neuron index) and sums compiled log-probabilities,
here there is a single pure function

    log_joint(params, data) = Σ_n LL_n(params, data) + Σ_components log-prior

vectorized over all N neurons at once: the per-neuron likelihood factorizes
(SURVEY.md §2 "parallelism"), so the whole population's currents are computed
as batched matmuls/einsums that XLA hands to the device's matrix units. The reference's
``set_data`` (precompute design tensors into Theano shared storage) becomes
:meth:`Population.prepare_data`, which builds plain arrays.

Public surface (reference parity):
  sample(key)                  ≅ Population.sample        — prior draw
  log_joint / log_likelihood / log_prior ≅ compute_log_p
  prepare_data                 ≅ set_data
  simulate(key, params, T)     ≅ Population.simulate      — lax.scan sampler
  currents(params, data)       — per-component currents (for plotting)

The forward simulation (§3.1 hot loop — a Python loop over ~60k bins in the
reference) is a single ``lax.scan`` over time with an (L, N) ring buffer of
recent spikes contracted against the effective (N, N, L) coupling filters.
"""

from __future__ import annotations

import copy
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from theano_pyglm_tpu.models.components import (
    make_bias,
    make_bkgd,
    make_impulse,
    make_nlin,
    make_observation,
)
from theano_pyglm_tpu.models.network import make_graph, make_weights
from theano_pyglm_tpu.models.spec import validate_spec
from theano_pyglm_tpu.ops.basis import create_basis
from theano_pyglm_tpu.ops.convolve import convolve_with_basis, upsample_stim
from theano_pyglm_tpu.utils.dtypes import default_float, full_precision_matmuls

__all__ = ["Population"]


class Population:
    """A population of N coupled GLMs, built from a nested-dict model spec.

    The spec format mirrors the reference's model dicts (pyglm/models/*,
    SURVEY.md §2 "Model zoo"); see :mod:`theano_pyglm_tpu.models.zoo` for
    templates. The instance holds only *static* structure (spec, bases,
    component function records); all state lives in the params pytree and the
    data dict, so every method is jit/vmap/grad-safe.
    """

    def __init__(
        self,
        spec: dict,
        design_dtype=None,
        time_chunk: Optional[int] = None,
    ):
        """``design_dtype=jnp.bfloat16`` stores the (large) spike design
        tensor X_imp in bf16, halving the bytes every likelihood/gradient
        pass reads (matmuls still accumulate in f32). ``bench.py --all``
        prints its accuracy cost against the f32 design (log-joint rel,
        gradient rel-L2, coupling-current rel-L2); its speed on the H100 is
        not measured yet (ROADMAP D2). The default stays f32, which is what
        the 1e-6 oracle parity tests verify.

        ``time_chunk``: evaluate the likelihood (and its VJP) in time blocks
        of this many bins via ``lax.map`` — the SURVEY §5 long-context
        chunking. Combined with ``prepare_data(materialize_design=False)``
        (X_imp rebuilt per block from the spikes with an L-bin halo), memory
        is bounded by the block size instead of T·N·B, so recordings larger
        than device memory stream."""
        validate_spec(spec)
        self.spec = copy.deepcopy(spec)
        self.N = int(spec["N"])
        self.dt = float(spec.get("dt", 1e-3))
        self.design_dtype = design_dtype
        self.time_chunk = int(time_chunk) if time_chunk else None

        # -- bases (host-side, built once; ≅ reference create_basis in set_data)
        imp_spec = dict(spec.get("impulse", {"type": "basis"}))
        imp_basis_spec = dict(imp_spec.get("basis", {"type": "cosine", "n_bas": 5}))
        imp_basis_spec.setdefault("dt", self.dt)
        imp_basis_spec.setdefault("dt_max", imp_spec.get("dt_max", 0.1))
        self.basis_imp = np.asarray(create_basis(imp_basis_spec))
        self.B_imp = self.basis_imp.shape[1]
        self.L_imp = self.basis_imp.shape[0]

        bkgd_spec = dict(spec.get("bkgd", {"type": "none"}))
        self.D_stim = int(bkgd_spec.get("D_stim", 1))
        if bkgd_spec.get("type", "none") != "none":
            stim_basis_spec = dict(bkgd_spec.get("basis", {"type": "cosine", "n_bas": 5}))
            stim_basis_spec.setdefault("dt", self.dt)
            stim_basis_spec.setdefault("dt_max", bkgd_spec.get("dt_max", 0.3))
            self.basis_stim = np.asarray(create_basis(stim_basis_spec))
            self.B_stim = self.basis_stim.shape[1]
        else:
            self.basis_stim = None
            self.B_stim = 0

        # -- components
        N = self.N
        self.bias = make_bias(dict(spec.get("bias", {})), N)
        self.bkgd = make_bkgd(bkgd_spec, N, self.B_stim, self.D_stim)
        self.impulse = make_impulse(imp_spec, N, self.B_imp)
        self.nlin = make_nlin(dict(spec.get("nlin", {"type": "exp"})))
        self.observation = make_observation(dict(spec.get("observation", {"type": "poisson"})))
        net_spec = dict(spec.get("network", {}))
        self.graph = make_graph(dict(net_spec.get("graph", {"type": "complete"})), N)
        self.weights = make_weights(dict(net_spec.get("weight", {"type": "constant"})), N)

        self._current_components = [self.bias, self.bkgd, self.impulse]
        self._prior_components = [self.bias, self.bkgd, self.impulse]

    # --- parameters -------------------------------------------------------

    def sample(self, key) -> dict:
        """Draw a full parameter pytree from the prior (≅ Population.sample)."""
        keys = jax.random.split(key, len(self._prior_components) + 2)
        params: dict = {}
        for comp, k in zip(self._prior_components, keys):
            params.update(comp.sample(k))
        params.update(self.graph.sample(keys[-2]))
        params.update(self.weights.sample(keys[-1]))
        return params

    def coupling(self, params) -> jax.Array:
        """Effective coupling G = A ∘ W, shape (N_post, N_pre)."""
        return params["A"] * self.weights.effective_W(params)

    # --- data -------------------------------------------------------------

    def prepare_data(
        self,
        S,
        stim=None,
        stim_dt: Optional[float] = None,
        materialize_design: bool = True,
    ) -> dict:
        """Precompute design tensors (≅ the reference's ``set_data``).

        Args:
          S: (T, N) spike counts (float or int).
          stim: optional (T_stim, D) stimulus at interval ``stim_dt``
                (defaults to the bin width ``dt``).
          materialize_design: build X_imp (T,N,B) up front (default). With
                False, only S is kept and the likelihood reconstructs each
                time block's design on the fly (requires ``time_chunk`` on
                the Population) — T·N·B never has to fit in device memory.
        Returns:
          data dict with 'S' (T,N), 'X_imp' (T,N,B_imp) and, if the model has
          a stimulus component, 'X_stim' (T, D·B_stim) or 'X_st' (T,D,B_stim).
        """
        S = jnp.asarray(S, default_float())
        T = S.shape[0]
        data = {"S": S}
        if materialize_design:
            X_imp = convolve_with_basis(S, jnp.asarray(self.basis_imp))
            # Center the spike design columns (exact reparameterization: the
            # column means re-enter the currents as a per-pair constant). Raw
            # X_imp columns have mean ≈ rate·Σφ, which couples every coupling
            # weight to the bias along a razor-thin ridge — centering removes
            # the dominant correlation and conditions both L-BFGS and HMC.
            X_mean = jnp.mean(X_imp, axis=0)  # (N_pre, B)
            X_imp = X_imp - X_mean[None]
            if self.design_dtype is not None:
                X_imp = X_imp.astype(self.design_dtype)
            data["X_imp"] = X_imp
            data["_X_imp_mean"] = X_mean
        if self.basis_stim is not None:
            if stim is None:
                raise ValueError("model has a stimulus component but no stim given")
            stim = jnp.asarray(stim, default_float())
            if stim.ndim == 1:
                stim = stim[:, None]
            if stim_dt is not None and stim_dt != self.dt:
                stim = upsample_stim(stim, stim_dt, self.dt, T)
            stim = stim[:T]
            X = convolve_with_basis(stim, jnp.asarray(self.basis_stim))  # (T, D, Bs)
            if self.bkgd.name == "bkgd" and self.spec["bkgd"]["type"] == "spatiotemporal":
                data["X_st"] = X
            else:
                data["X_stim"] = X.reshape(T, -1)
        return data

    # --- densities ---------------------------------------------------------

    def currents(self, params, data) -> dict:
        """Per-component additive currents, each (T, N) (for analysis/plots)."""
        d = dict(data)
        d["_G"] = self.coupling(params)
        return {c.name: c.current(params, d) for c in self._current_components}

    def total_current(self, params, data) -> jax.Array:
        d = dict(data)
        d["_G"] = self.coupling(params)
        I = jnp.zeros_like(data["S"])
        for c in self._current_components:
            I = I + c.current(params, d)
        return I

    def log_likelihood_per_neuron(self, params, data) -> jax.Array:
        """(N,) spike log-likelihood per postsynaptic neuron (factorizes)."""
        with full_precision_matmuls():
            if self.time_chunk is not None and data["S"].shape[0] > self.time_chunk:
                return self._ll_per_neuron_chunked(params, data)
            if "X_imp" not in data:
                raise ValueError(
                    "data was prepared with materialize_design=False; build the "
                    "Population with time_chunk=<bins> so the likelihood can "
                    "stream the design per time block"
                )
            I = self.total_current(params, data)
            ll = self.observation.log_likelihood(data["S"], I, self.nlin, self.dt)
            return jnp.sum(ll, axis=0)

    def _ll_per_neuron_chunked(self, params, data) -> jax.Array:
        """Time-chunked (N,) log-likelihood: ``lax.map`` over blocks of
        ``time_chunk`` bins (SURVEY.md §5 "Long-context"). The LL is a plain
        sum over bins, so blocks are independent given the params; each block
        is rematerialized in the VJP (jax.checkpoint), so neither the forward
        intermediates nor the backward residuals ever hold more than one
        block. When X_imp is absent (``materialize_design=False``) the
        block's design tensor is rebuilt from the spikes with an L-bin halo —
        exact, because the convolution is strictly causal with L-bin support.
        """
        C = self.time_chunk
        S = data["S"]
        T, N = S.shape
        L = self.L_imp
        n_chunks = -(-T // C)
        T_pad = n_chunks * C
        streaming = "X_imp" not in data

        def pad0(x):
            return jnp.pad(x, [(0, T_pad - T)] + [(0, 0)] * (x.ndim - 1))

        time_keys = [k for k in ("X_imp", "X_stim", "X_st") if k in data]
        chunks = {
            k: pad0(data[k]).reshape((n_chunks, C) + data[k].shape[1:])
            for k in time_keys
        }
        S_pad = pad0(S)
        chunks["S"] = S_pad.reshape(n_chunks, C, N)
        chunks["_mask"] = (jnp.arange(T_pad) < T).reshape(n_chunks, C)
        static = {k: v for k, v in data.items()
                  if k not in time_keys and k not in ("S",)}
        static["_G"] = self.coupling(params)
        if streaming:
            S_halo = jnp.concatenate(
                [jnp.zeros((L, N), S_pad.dtype), S_pad], axis=0
            )
            basis = jnp.asarray(self.basis_imp)

        @jax.checkpoint
        def one(args):
            i, ch = args
            d = dict(static)
            d["S"] = ch["S"]
            for k in time_keys:
                d[k] = ch[k]
            if streaming:
                # rows [i·C, i·C + C + L) of [zeros(L); S_pad]: the block
                # plus its exact causal history
                Sh = jax.lax.dynamic_slice(S_halo, (i * C, 0), (C + L, N))
                X = convolve_with_basis(Sh, basis)[L:]
                if self.design_dtype is not None:
                    X = X.astype(self.design_dtype)
                d["X_imp"] = X
            I = jnp.zeros_like(ch["S"])
            for comp in self._current_components:
                I = I + comp.current(params, d)
            ll = self.observation.log_likelihood(ch["S"], I, self.nlin, self.dt)
            return jnp.sum(ll * ch["_mask"][:, None], axis=0)

        per = jax.lax.map(one, (jnp.arange(n_chunks), chunks))  # (n_chunks, N)
        return jnp.sum(per, axis=0)

    def log_likelihood(self, params, data) -> jax.Array:
        return jnp.sum(self.log_likelihood_per_neuron(params, data))

    def log_prior(self, params) -> jax.Array:
        lp = jnp.asarray(0.0)
        for comp in self._prior_components:
            lp = lp + comp.log_prior(params)
        lp = lp + self.graph.log_prior(params)
        lp = lp + self.weights.log_prior(params)
        return lp

    def log_joint(self, params, data) -> jax.Array:
        """The single scalar the reference calls ``log_p`` (SURVEY.md §1)."""
        return self.log_likelihood(params, data) + self.log_prior(params)

    # --- simulation ---------------------------------------------------------

    def effective_filters(self, params) -> jax.Array:
        """(N_post, N_pre, L) coupling filters h = G ∘ (w_eff · basisᵀ)."""
        w_eff = self.impulse.effective(params)  # (N, N, B)
        h = jnp.einsum("npb,lb->npl", w_eff, jnp.asarray(self.basis_imp))
        return h * self.coupling(params)[:, :, None]

    def simulate(
        self,
        key,
        params,
        T: int,
        stim=None,
        stim_dt: Optional[float] = None,
        rate_max: float = 1e4,
    ):
        """Forward-generate spikes for T bins (≅ Population.simulate).

        A single ``lax.scan`` over time; the carry is an (L, N) ring buffer of
        the last L bins of spikes (row l = bin t-1-l), contracted against the
        effective (N, N, L) filters each step — the strictly-causal
        counterpart of :func:`ops.convolve.convolve_with_basis`.

        ``rate_max`` (spikes/s) bounds the rate during generation to keep
        runaway self-excitation finite (documented spec; the reference bounds
        the rate in its Bernoulli sampler, SURVEY.md §2 [M]).

        The whole generator runs as ONE jit-compiled program per (T, stim
        shape), cached on the instance: run eagerly, the 60k-step scan would
        dispatch every step from the host.

        Returns:
          (S, rates): spike counts (T, N) and rates λ in spikes/s (T, N).
        """
        if self.basis_stim is not None and stim is None:
            raise ValueError("model has a stimulus component but no stim given")
        if stim is not None:
            stim = jnp.asarray(stim, default_float())
            if stim.ndim == 1:
                stim = stim[:, None]
        cache = self.__dict__.setdefault("_simulate_cache", {})
        cache_key = (
            int(T),
            None if stim is None else tuple(stim.shape),
            stim_dt,
        )
        if cache_key not in cache:
            cache[cache_key] = jax.jit(
                lambda k, p, st, rm: self._simulate_impl(k, p, T, st, stim_dt, rm)
            )
        S, rates = cache[cache_key](
            key, params, stim, jnp.asarray(rate_max, default_float())
        )
        return S, rates

    def _simulate_impl(self, key, params, T, stim, stim_dt, rate_max):
        N, L = self.N, self.L_imp
        h_eff = self.effective_filters(params)  # (N, N, L)

        I_base = jnp.broadcast_to(params["bias"][None, :], (T, N))
        if self.basis_stim is not None:
            if stim_dt is not None and stim_dt != self.dt:
                stim = upsample_stim(stim, stim_dt, self.dt, T)
            X = convolve_with_basis(stim[:T], jnp.asarray(self.basis_stim))
            fake = {"S": jnp.zeros((T, N))}
            if self.spec.get("bkgd", {}).get("type") == "spatiotemporal":
                fake["X_st"] = X
            else:
                fake["X_stim"] = X.reshape(T, -1)
            I_base = I_base + self.bkgd.current(params, fake)

        keys = jax.random.split(key, T)

        def step(buf, inputs):
            k, I_b = inputs
            I_net = jnp.einsum("lp,npl->n", buf, h_eff)
            I = I_b + I_net
            rate = jnp.clip(self.nlin.rate(I), 0.0, rate_max)
            S_t = self.observation.sample(k, rate, self.dt)
            buf = jnp.concatenate([S_t[None, :], buf[:-1]], axis=0)
            return buf, (S_t, rate)

        buf0 = jnp.zeros((L, N))
        _, (S, rates) = jax.lax.scan(step, buf0, (keys, I_base))
        return S, rates
