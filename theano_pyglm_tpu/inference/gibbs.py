"""Discrete Gibbs machinery — adjacency, SBM types, conjugate hypers.

Rebuild of the discrete updates in ``pyglm/inference/gibbs.py`` (SURVEY.md §2
"MCMC: Gibbs loop", §3.3). The reference sweeps A entry-by-entry, evaluating
the full conditional log-p at A_ij ∈ {0,1} — an O(N²) sweep of full
likelihood evaluations. Here the same sweep uses the **incremental Δlog-lik
trick** (SURVEY.md §7 "Hard parts"): flipping A[n, m] only perturbs neuron
n's current by W[n,m]·ψ[:, n, m], where

    ψ[t, n, m] = X_imp[t, m, :] · w_eff[n, m, :]

is precomputed once per sweep (one batched einsum). Because the
likelihood factorizes over postsynaptic neurons and every graph prior has
conditionally independent edges given its latents, all N rows of A update in
parallel (``vmap`` over n) while entries within a row update sequentially
(``lax.scan`` over m, carrying the running current) — exactly the reference's
per-neuron parallelism mapped onto one batched device program.

Also here: Gibbs over SBM type assignments y (sequential scan over neurons,
vectorized over the K classes), conjugate Beta/Dirichlet hyper resampling for
the SBM block matrix and mixing weights, conjugate Beta update for the
Erdős–Rényi density, and prior refresh of disconnected weights (the exact
conditional p(W[n,m] | A[n,m]=0) is the prior).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from theano_pyglm_tpu.ops.clipping import clip_exponent, exp_clipped, exponent_active

_SEED_MODE = "prior_mean"  # birth-death Newton seed; see update_adjacency_collapsed

# Proposal-shaping time-subsample geometry for the collapsed (A,W) update
# (see the block comment inside update_adjacency_collapsed). Module-level so
# tests can shrink them and exercise the flagship-scale subsample path
# (T > SUBSAMPLE_T) on CPU-sized problems — the path where a formulation bug
# froze/crashed the round-3 flagship twice before any small-T test noticed.
SUBSAMPLE_T = 16384  # Newton fits run on at most this many bins
SUBSAMPLE_BLK = 2048  # contiguous bins per dynamic-slice block

__all__ = [
    "compute_psi",
    "update_adjacency",
    "update_adjacency_collapsed",
    "update_glm_laplace",
    "update_glm_laplace_st",
    "update_glm_laplace_shared",
    "refresh_disconnected_weights",
    "update_weight_hypers",
    "update_sbm_types",
    "update_sbm_types_collapsed",
    "update_sbm_hypers",
    "update_er_rho",
]


def compute_psi(pop, params, data) -> jax.Array:
    """Unit-coupling currents ψ (T, N_post, N_pre) (see module docstring)."""
    w_eff = pop.impulse.effective(params)  # (N, N, B)
    X = data["X_imp"]
    if X.dtype == jnp.bfloat16:
        psi = jnp.einsum(
            "tmb,nmb->tnm", X, w_eff.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    else:
        psi = jnp.einsum("tmb,nmb->tnm", X, w_eff)
    mean = data.get("_X_imp_mean")
    if mean is not None:
        psi = psi + jnp.einsum("mb,nmb->nm", mean, w_eff)[None]
    return psi


def _psi_from_X(X, mean, w_eff_n) -> jax.Array:
    """One ψ row from an explicit design block: (T', N_pre) from X (T', N,
    B) and one postsynaptic row's effective filter weights (N_pre, B).
    ``mean`` is the optional bf16 mean-centering correction
    (``_X_imp_mean``)."""
    if X.dtype == jnp.bfloat16:
        psi_n = jnp.einsum(
            "tmb,mb->tm", X, w_eff_n.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    else:
        psi_n = jnp.einsum("tmb,mb->tm", X, w_eff_n)
    if mean is not None:
        psi_n = psi_n + jnp.sum(mean * w_eff_n, axis=-1)[None]
    if X.dtype == jnp.bfloat16:
        # the user opted into bf16 design tensors; ψ dominates the sweep's
        # memory traffic, so carry it at the same precision
        psi_n = psi_n.astype(jnp.bfloat16)
    return psi_n


def _row_psi(pop, data, w_eff_n) -> jax.Array:
    """One postsynaptic row of ψ: (T, N_pre) from X_imp and that row's
    effective filter weights (N_pre, B). Computed *inside* the row update so
    the full (T, N_post, N_pre) ψ tensor is never materialized when rows are
    streamed (``row_batch``) — the long-context fix from SURVEY.md §5: at
    N=100/T=600k full ψ is 24 GB, one row is 240 MB."""
    X = data.get("X_imp")
    if X is None:
        raise ValueError(
            "adjacency updates need a materialized spike design "
            "(prepare_data(materialize_design=True)); the streaming data mode "
            "covers likelihood/MAP/HMC paths only"
        )
    return _psi_from_X(X, data.get("_X_imp_mean"), w_eff_n)


def _map_rows(row_fn, args: tuple, row_batch):
    """vmap over postsynaptic rows (default — XLA materializes all rows at
    once, fine when T·N² fits device memory) or lax.map with ``row_batch`` rows in
    flight (bounded memory for long recordings / large N)."""
    if row_batch is None:
        return jax.vmap(row_fn)(*args)
    return jax.lax.map(lambda a: row_fn(*a), args, batch_size=int(row_batch))


def rest_current(pop, params, data) -> jax.Array:
    """(T, N) currents from everything except the coupling term."""
    I = pop.bias.current(params, data)
    I = I + pop.bkgd.current(params, data)
    return I


def update_adjacency(key, pop, params, data, row_batch=None, beta=1.0):
    """Collapsed-Gibbs sweep over all N² adjacency entries.

    p(A[n,m]=1 | rest) ∝ p_prior(n,m) · exp(β·LL_n(I_rest + ψ·W added))
    — sampled row-parallel / entry-sequential as described above. ``beta``
    tempers the LIKELIHOOD only (annealed warmup; 1.0 = exact posterior).
    """
    if pop.graph.fixed_A:
        return params

    S, dt, nlin, obs = data["S"], pop.dt, pop.nlin, pop.observation
    N = pop.N
    w_eff = pop.impulse.effective(params)  # (N_post, N_pre, B)
    I_rest = rest_current(pop, params, data)  # (T, N)
    W = pop.weights.effective_W(params)  # (N, N)
    P = pop.graph.edge_prob(params)
    logit_prior = jnp.log(jnp.clip(P, 1e-12, 1.0)) - jnp.log(jnp.clip(1.0 - P, 1e-12, 1.0))

    def ll_of(I_n, S_n):
        return jnp.sum(obs.log_likelihood(S_n, I_n, nlin, dt))

    def row_update(key_n, A_n, W_n, w_eff_n, S_n, I_rest_n, logit_n):
        # ψ row computed here (never the full (T,N,N) tensor — see _row_psi);
        # running current for this postsynaptic neuron.
        psi_n = _row_psi(pop, data, w_eff_n)
        I_n = I_rest_n + psi_n @ (A_n * W_n)
        keys = jax.random.split(key_n, N)

        def step(carry, inp):
            I_n, A_n = carry
            m, k = inp
            contrib = W_n[m] * psi_n[:, m]
            I_wo = I_n - A_n[m] * contrib
            delta = beta * (ll_of(I_wo + contrib, S_n) - ll_of(I_wo, S_n))
            logit_post = delta + logit_n[m]
            a_new = jax.random.bernoulli(k, jax.nn.sigmoid(logit_post)).astype(A_n.dtype)
            I_n = I_wo + a_new * contrib
            A_n = A_n.at[m].set(a_new)
            return (I_n, A_n), None

        (I_n, A_n), _ = jax.lax.scan(step, (I_n, A_n), (jnp.arange(N), keys))
        return A_n

    keys = jax.random.split(key, N)
    A_new = _map_rows(
        row_update,
        (keys, params["A"], W, w_eff, S.T, I_rest.T, logit_prior),
        row_batch,
    )
    return {**params, "A": A_new}


def update_adjacency_collapsed(
    key, pop, params, data, n_newton: int = 8, return_accept: bool = False,
    row_batch=None, beta=1.0,
):
    """Joint (A[n,m], W[n,m]) birth–death update — the mixing-correct
    counterpart of the reference's *collapsed* adjacency Gibbs (SURVEY.md §2
    "MCMC: Gibbs loop": "for Gaussian weights the W can be marginalized").

    Plain single-site Gibbs on A with stored slab weights mixes pathologically:
    an edge that switches off has its weight refreshed from the prior, and the
    later birth proposal is evaluated at that random weight, so good edges die
    and cannot be reborn. The fix is to update the *pair* per entry with an
    independence Metropolis–Hastings move whose proposal approximates the
    collapsed conditional:

      1. Laplace-fit g(W) = ΔLL(W) + log N(W | μ, σ) by Newton on the 1-D
         weight (autodiff gradients, so any nonlinearity/observation works);
      2. estimate the edge's marginal evidence Ẑ₁ = ∫e^g ≈ e^{g(W*)}·√(2π)·s,
         giving the collapsed birth probability
         p̂ = ρẐ₁ / (ρẐ₁ + (1−ρ));
      3. propose A' ~ Bern(p̂); W' ~ N(W*, s²) if A'=1 else W' ~ N(μ, σ²);
      4. MH-accept the pair (exactness does not rely on the Laplace
         approximation — only proposal quality does).

    Entries within a row update sequentially (scan, carrying the row current);
    rows update in parallel (vmap) exactly as in :func:`update_adjacency`.
    """
    if pop.graph.fixed_A:
        return (params, jnp.asarray(1.0)) if return_accept else params
    if not pop.weights.has_W:
        out = update_adjacency(key, pop, params, data, row_batch=row_batch, beta=beta)
        return (out, jnp.asarray(1.0)) if return_accept else out

    S, dt, nlin, obs = data["S"], pop.dt, pop.nlin, pop.observation
    N = pop.N
    w_eff_all = pop.impulse.effective(params)  # (N_post, N_pre, B)
    I_rest = rest_current(pop, params, data)
    MU, SIG = pop.weights.prior_mu_sigma(params)
    P = pop.graph.edge_prob(params)
    logit_prior = jnp.log(jnp.clip(P, 1e-12, 1.0)) - jnp.log(jnp.clip(1.0 - P, 1e-12, 1.0))
    _LOG2PI = 1.8378770664093453

    fast_path = nlin.name == "exp" and obs.name == "poisson"

    # Proposal-shaping time subsample, drawn ONCE per sweep: contiguous
    # blocks (streaming reads) at RANDOM offsets redrawn every sweep. A
    # deterministic stratified layout froze flagship entries permanently —
    # one unlucky entry's static subsample put the Newton mode ~4 posterior
    # sds from the truth EVERY sweep, so the independence proposal never
    # covered the current state and the MH rejected all moves for 10k
    # sweeps (round-3 post-mortem). Random
    # offsets make proposal bias a per-sweep coin flip instead of a
    # permanent property of the entry; the freeze mechanism only needs the
    # offsets to change ACROSS sweeps, so one draw is shared by every row
    # (and, under the chains vmap, redrawn per chain via the sweep key).
    #
    # Layout: the subsample is materialized as contiguous dynamic-slice
    # blocks of the shared design X_imp (+ S, I_rest) once per sweep; each
    # row's subsampled ψ is then a small matmul (X_sub @ w_eff_n). Gathering
    # ψ per (row, chain) inside the vmap instead makes XLA lower a
    # random-row gather of that shape to a serialized loop, which slowed the
    # 4-chain flagship-scale update about 18× on the accelerator this was
    # first built for (not measured on the H100).
    T_full = int(S.shape[0])
    T_sub = min(T_full, SUBSAMPLE_T)
    use_sub = fast_path and T_sub < T_full
    if use_sub:
        if "X_imp" not in data:
            # fail with the designed message (see _row_psi) rather than a
            # bare KeyError — long recordings are exactly where streaming
            # data mode gets used
            _row_psi(pop, data, w_eff_all[0])
        key, k_sub = jax.random.split(key)
        blk = SUBSAMPLE_BLK
        n_blk = T_sub // blk
        offs = jax.random.randint(k_sub, (n_blk,), 0, T_full - blk)

        def _blocks(arr):
            # n_blk contiguous dynamic slices, NOT a flat 16k-row gather:
            # XLA lowers a random-row gather of this shape to a serialized
            # per-row loop; contiguous dynamic slices are plain copies.
            return jnp.concatenate(
                [
                    jax.lax.dynamic_slice_in_dim(arr, offs[j], blk, axis=0)
                    for j in range(n_blk)
                ],
                axis=0,
            )

        X_sub = _blocks(data["X_imp"])  # (T_sub, N, B)
        S_sub = _blocks(S)  # (T_sub, N)
        I_rest_sub = _blocks(I_rest)  # (T_sub, N)
        scale_sub = T_full / T_sub
    else:
        S_sub, I_rest_sub = S, I_rest  # aliases; unused branches DCE'd
        scale_sub = 1.0

    def row_update(
        key_n, A_n, W_n, w_eff_n, S_n, I_rest_n, mu_n, sig_n, logit_n,
        S_sub_n, I_rest_sub_n,
    ):
        psi_n = _row_psi(pop, data, w_eff_n)
        I_n = I_rest_n + psi_n @ (A_n * W_n)
        keys = jax.random.split(key_n, N)

        if use_sub:
            psi_n_sub = _psi_from_X(X_sub, data.get("_X_imp_mean"), w_eff_n)
            I_n_sub0 = I_rest_sub_n + psi_n_sub @ (A_n * W_n)
            S_n_sub = S_sub_n
        else:
            # subsample == full grid; I_n itself is the tracked current, so
            # the scan carries no separate I_n_sub (saves 2 T-length vector
            # ops per entry on every small-T run)
            psi_n_sub, S_n_sub = psi_n, S_n
        a_sub_all = (S_n_sub @ psi_n_sub) * scale_sub  # (N,) hoisted Σ S·ψ

        def entry(carry, inp):
            # fast path carries the current state's likelihood scalars
            # (Σ S·clip(I_n), Σ e^{clip(I_n)}) so dll_cur costs no T-pass
            if use_sub:
                if fast_path:
                    I_n, I_n_sub, A_n, W_n, sS_In, sE_In = carry
                else:
                    I_n, I_n_sub, A_n, W_n = carry
            else:
                if fast_path:
                    I_n, A_n, W_n, sS_In, sE_In = carry
                else:
                    I_n, A_n, W_n = carry
                I_n_sub = I_n
            m, k = inp
            k_a, k_w, k_mix, k_u = jax.random.split(k, 4)
            psi_m = psi_n[:, m]
            I_wo = I_n - A_n[m] * W_n[m] * psi_m
            mu, sig = mu_n[m], sig_n[m]

            if fast_path:
                # Closed forms for the exp-Poisson GLM with the CLIPPED-exp
                # model (λ = e^{clip(I)}, log λ = clip(I) — see make_nlin):
                #   ΔLL(w) = Σ S·(clip(I_wo+wψ) − clip(I_wo))
                #            − dt·Σ (e^{clip(I_wo+wψ)} − e^{clip(I_wo)})
                # — fused T-passes instead of nested autodiff. The clip on
                # the COMBINED exponent (not per-term) both matches the
                # likelihood the HMC blocks sample — the MH ratio stays
                # exact even when an excursion saturates the clip — and
                # bounds every exp at e^40 so the f32 reduction cannot
                # overflow to inf (inf−inf ⇒ NaN ⇒ the permanently
                # rejecting frozen chain observed on the round-2 flagship).
                # Clip spec: ops/clipping.py (single source of truth).
                #
                # EVERYTHING proposal-shaping (Newton iterations AND the
                # Laplace edge evidence Ẑ₁) runs on the per-sweep random
                # time subsample drawn above; only the MH ratio's two ΔLL
                # evaluations touch the full T grid. The sweep is
                # bandwidth-bound and this stage led every earlier profile;
                # exactness never rests on the proposal, only on the ratio.
                psi_s = psi_n_sub[:, m]
                I_s = I_n_sub - A_n[m] * W_n[m] * psi_s
                a_sub = a_sub_all[m]  # Σ S·ψ·scale (precomputed per row)
                I0s_c = clip_exponent(I_s)
                sum_E0s = jnp.sum(jnp.exp(I0s_c))
                sum_S_I0s = S_n_sub @ I0s_c

                def dll_fit(w):
                    # SUBSAMPLED ΔLL — shapes the proposal (evidence Ẑ₁);
                    # β tempers the likelihood term only (annealed warmup)
                    I1 = clip_exponent(I_s + w * psi_s)
                    return beta * scale_sub * (
                        (S_n_sub @ I1 - sum_S_I0s)
                        - dt * (jnp.sum(jnp.exp(I1)) - sum_E0s)
                    )

                def dll_grad_hess(w):
                    # proposal-shaping only; the combined-exponent clip
                    # keeps u ≤ e^40 (no f32 inf)
                    u = exp_clipped(I_s + w * psi_s)
                    return (
                        beta * (a_sub - dt * scale_sub * (u @ psi_s)),
                        beta * (-dt * scale_sub * (u @ (psi_s * psi_s))),
                    )

            else:

                def dll_fit(w):
                    # ΔLL(w): likelihood gain of the edge at weight w
                    # (generic path: no subsample machinery, exact ΔLL).
                    return beta * jnp.sum(
                        obs.log_likelihood(S_n, I_wo + w * psi_m, nlin, dt)
                        - obs.log_likelihood(S_n, I_wo, nlin, dt)
                    )

                _d1 = jax.grad(dll_fit)

                def dll_grad_hess(w):
                    return _d1(w), jax.grad(_d1)(w)

            def g(w):
                z = (w - mu) / sig
                return dll_fit(w) - 0.5 * (z * z + _LOG2PI) - jnp.log(sig)

            def g_grad_hess(w):
                d1, d2 = dll_grad_hess(w)
                return d1 - (w - mu) / (sig * sig), d2 - 1.0 / (sig * sig)

            # Newton from the prior mean — a STATE-INDEPENDENT seed, so the
            # proposal is a genuine independence proposal and the MH ratio
            # below is exact (seeding from the current weight would make
            # q(x'|x) ≠ q(x'), a residual approximation detailed balance
            # can't absorb). Log-concave targets converge from mu in the
            # n_newton damped steps regardless. (_SEED_MODE='state' restores
            # the round-1 state-dependent seed for A/B diagnostics only.)
            w0 = mu if _SEED_MODE == "prior_mean" else jnp.where(A_n[m] > 0, W_n[m], mu)

            def newton(w, _):
                d1, d2 = g_grad_hess(w)
                h = jnp.minimum(d2, -0.1 / (sig * sig))
                return w - d1 / h, None

            w_star, _ = jax.lax.scan(newton, w0, None, length=n_newton)
            h_star = jnp.minimum(g_grad_hess(w_star)[1], -0.1 / (sig * sig))
            s = jnp.sqrt(-1.0 / h_star)

            # Laplace evidence of the edge (A=0 evidence is exactly 1).
            # PROPOSAL ROBUSTNESS (flagship freeze post-mortem, see the
            # subsample note above). An independence MH can only leave a
            # state that its proposal can come back to: the acceptance of
            # any exit is bounded by q(current)/π(current). Two defenses
            # keep that ratio bounded even when the Laplace fit is off:
            #   1. the proposal's birth probability is clipped to
            #      [σ(−3.5), σ(3.5)] ≈ [0.03, 0.97] — both A states stay
            #      proposable every sweep (the TARGET's logit is untouched;
            #      the MH ratio absorbs the difference exactly);
            #   2. the birth weight is a DEFENSIVE MIXTURE
            #      0.8·N(w*, s²) + 0.2·N(μ, σ²) — the prior component keeps
            #      q(w_current) ≥ 0.2·prior(w_current), so a mis-centered
            #      Newton mode cannot drive the reverse density to e^{-15}
            #      and freeze the entry.
            log_z1 = g(w_star) + 0.5 * (_LOG2PI) + jnp.log(s)
            logit_birth = jnp.clip(logit_n[m] + log_z1, -3.5, 3.5)
            p_birth = jax.nn.sigmoid(logit_birth)

            a_prop = jax.random.bernoulli(k_a, p_birth).astype(A_n.dtype)
            use_hat = jax.random.uniform(k_mix) < 0.8
            w_birth = jnp.where(
                use_hat,
                w_star + s * jax.random.normal(k_w),
                mu + sig * jax.random.normal(k_w),
            )
            w_prop = jnp.where(a_prop > 0, w_birth, mu + sig * jax.random.normal(k_w))

            # Exact full-T ΔLL at the two weights the MH ratio needs.
            # Fast path: ONE full-T reduction group — the proposal's
            # combined exponent clip(I_wo + w_prop·ψ) and the baseline
            # clip(I_wo) sums share a single read of (I_n, ψ_m, S_n); the
            # CURRENT state's term is free because clip(I_wo + W_cur·ψ) is
            # (to float reordering) exactly the carried current I_n, whose
            # likelihood scalars (Σ S·clip(I_n), Σ e^{clip(I_n)}) ride the
            # scan carry and are refreshed in the update pass below. When
            # A[n,m]=0 the carried scalars describe the wrong current, but
            # then log_target multiplies dll_cur by a=0 — always finite,
            # never consumed. (A fused (T,3) stacked-matrix formulation was
            # also built and measured AGAINST this: 21.9 vs 14.6 ms for the
            # 4-chain flagship sweep — the stack defeats the sibling-
            # reduction fusion XLA finds for the separate reductions.)
            if fast_path:
                I_wo_c = clip_exponent(I_wo)
                I1p_c = clip_exponent(I_wo + w_prop * psi_m)
                sum_S_Iwo = S_n @ I_wo_c
                sum_E_wo = jnp.sum(jnp.exp(I_wo_c))
                dll_prop = beta * (
                    (S_n @ I1p_c - sum_S_Iwo)
                    - dt * (jnp.sum(jnp.exp(I1p_c)) - sum_E_wo)
                )
                dll_cur = beta * (
                    (sS_In - sum_S_Iwo) - dt * (sE_In - sum_E_wo)
                )
            else:
                dll_prop, dll_cur = dll_fit(w_prop), dll_fit(W_n[m])

            def log_target(a, w, dll_w):
                zp = (w - mu) / sig
                lp = -0.5 * (zp * zp + _LOG2PI) - jnp.log(sig)
                return lp + a * (dll_w + logit_n[m])

            def log_proposal(a, w):
                zq = (w - w_star) / s
                lq_hat = -0.5 * (zq * zq + _LOG2PI) - jnp.log(s)
                zp = (w - mu) / sig
                lq0 = -0.5 * (zp * zp + _LOG2PI) - jnp.log(sig)
                lq1 = jnp.logaddexp(jnp.log(0.8) + lq_hat, jnp.log(0.2) + lq0)
                return jnp.where(
                    a > 0, jnp.log(p_birth) + lq1, jnp.log1p(-p_birth) + lq0
                )

            log_alpha = (
                log_target(a_prop, w_prop, dll_prop)
                - log_proposal(a_prop, w_prop)
                - log_target(A_n[m], W_n[m], dll_cur)
                + log_proposal(A_n[m], W_n[m])
            )
            accept = jnp.log(jax.random.uniform(k_u)) < log_alpha
            a_new = jnp.where(accept, a_prop, A_n[m])
            w_new = jnp.where(accept, w_prop, W_n[m])

            I_n = I_wo + a_new * w_new * psi_m
            A_up, W_up = A_n.at[m].set(a_new), W_n.at[m].set(w_new)
            if fast_path:
                # refresh the carried scalars from the carried current —
                # fused with the I_n update's read of (I_wo, ψ_m, S_n),
                # and recomputed unconditionally so scalars ≡ f(I_n) holds
                # whether or not the move was accepted
                I_n_c = clip_exponent(I_n)
                sS_In = S_n @ I_n_c
                sE_In = jnp.sum(jnp.exp(I_n_c))
            if use_sub:
                I_n_sub = (I_n_sub - A_n[m] * W_n[m] * psi_n_sub[:, m]) + (
                    a_new * w_new * psi_n_sub[:, m]
                )
                carry_out = (
                    (I_n, I_n_sub, A_up, W_up, sS_In, sE_In)
                    if fast_path else (I_n, I_n_sub, A_up, W_up)
                )
            else:
                carry_out = (
                    (I_n, A_up, W_up, sS_In, sE_In)
                    if fast_path else (I_n, A_up, W_up)
                )
            return carry_out, accept

        if fast_path:
            I_n_c0 = clip_exponent(I_n)
            sS0, sE0 = S_n @ I_n_c0, jnp.sum(jnp.exp(I_n_c0))
            init = (
                (I_n, I_n_sub0, A_n, W_n, sS0, sE0)
                if use_sub else (I_n, A_n, W_n, sS0, sE0)
            )
        else:
            init = (I_n, I_n_sub0, A_n, W_n) if use_sub else (I_n, A_n, W_n)
        out_carry, accepts = jax.lax.scan(entry, init, (jnp.arange(N), keys))
        if fast_path:
            A_n, W_n = out_carry[-4], out_carry[-3]
        else:
            A_n, W_n = out_carry[-2], out_carry[-1]
        return A_n, W_n, jnp.mean(accepts.astype(jnp.float32))

    keys = jax.random.split(key, N)
    A_new, W_new, acc = _map_rows(
        row_update,
        (keys, params["A"], params["W"], w_eff_all, S.T, I_rest.T, MU, SIG,
         logit_prior, S_sub.T, I_rest_sub.T),
        row_batch,
    )
    out = {**params, "A": A_new, "W": W_new}
    if return_accept:
        return out, jnp.mean(acc)
    return out


def _bin_ll_derivs(S, I, obs, nlin, dt):
    """Elementwise (d/dI, d²/dI²) of the per-bin log-likelihood at I.

    Fast closed form for the exp-Poisson clipped-exp model; any other
    (observation, nonlinearity) pair goes through elementwise autodiff —
    the per-bin LL is an elementwise map, so grad-of-sum IS the elementwise
    derivative and two nested grads give the curvature. This is what makes
    the Laplace glm update generic over softplus/Bernoulli variants."""
    if obs.name == "poisson" and nlin.name == "exp":
        lam_dt = exp_clipped(I) * dt
        mask = exponent_active(I).astype(I.dtype)
        return (S - lam_dt) * mask, -lam_dt * mask
    d1_fn = jax.grad(lambda i: jnp.sum(obs.log_likelihood(S, i, nlin, dt)))
    d1 = d1_fn(I)
    d2 = jax.grad(lambda i: jnp.sum(d1_fn(i)))(I)
    # Sanitize (proposal-shaping only — every MH ratio evaluates
    # obs.log_likelihood directly): autodiff of e.g. the softplus-Poisson
    # LL yields NaN/inf per-bin derivatives when the rate underflows on a
    # spiking bin (S·σ(I)/softplus(I) at I ≲ −90 in f32). Unsanitized,
    # one such bin makes theta_star, the Cholesky, and the reverse density
    # log_q(theta_cur) NaN EVERY sweep — the same permanently-rejecting
    # frozen chain the Laplace block exists to eliminate.
    d1 = jnp.nan_to_num(d1, nan=0.0, posinf=1e6, neginf=-1e6)
    d2 = jnp.nan_to_num(d2, nan=0.0, posinf=0.0, neginf=-1e6)
    return d1, d2


def _laplace_mh_block(
    key, S, dt, obs, nlin, I0, Phi, theta_cur, theta0,
    prior_mu, prior_sd, beta=1.0, n_newton: int = 6,
):
    """Per-neuron Laplace independence-MH on a LINEAR current block.

    Given the frozen rest-of-model current I0 (T, N), each neuron n's
    conditional over its D-vector θ_n with current I_n = I0_n + Φ_n θ_n is
    approximately Gaussian (for concave conditionals — any convex,
    log-concave nonlinearity per Paninski 2004 — exactly so as T → ∞).
    Newton from the STATE-INDEPENDENT seed ``theta0`` finds the mode θ*,
    the proposal is N(θ*, (−H*)⁻¹), and an exact per-neuron MH accept keeps
    the conditional invariant regardless of approximation quality. No step
    size exists anywhere: this replaces HMC on blocks whose per-neuron
    Fisher information spans orders of magnitude (rate-dependent), where a
    single HMC ε gets pinned at ~1e-4 by the stiffest neuron and chains
    take microscopic steps (the round-2 flagship's R̂-in-the-millions
    failure). With T in the tens of thousands acceptance is near 1 and the
    draws are near-iid.

    Args:
      Phi: design tensor, (T, D) shared across neurons or (T, N, D)
           per-neuron (the spatiotemporal/shared blocks need the latter).
      theta_cur/theta0: (N, D) current values and Newton seed.
      prior_mu/prior_sd: (D,) or (N, D) Gaussian prior on θ rows.
    Returns:
      (theta_new (N,D), accept (N,) bool).
    """
    f = S.dtype
    N, D = theta_cur.shape
    per_neuron_design = Phi.ndim == 3
    prior_mu = jnp.broadcast_to(jnp.asarray(prior_mu, f), (N, D))
    prior_sd = jnp.broadcast_to(jnp.asarray(prior_sd, f), (N, D))
    prior_prec = 1.0 / (prior_sd * prior_sd)

    def currents(theta):  # (N,D) -> (T,N)
        if per_neuron_design:
            return I0 + jnp.einsum("tnd,nd->tn", Phi, theta)
        return I0 + Phi @ theta.T

    def grad_negH(theta):  # (N,D) -> ((N,D), (N,D,D))
        I = currents(theta)
        d1, d2 = _bin_ll_derivs(S, I, obs, nlin, dt)
        # curvature clamp (proposal-shaping only; the MH ratio below is
        # exact): a non-concave pocket must not flip the Hessian sign
        d2 = jnp.minimum(d2, 0.0)
        if per_neuron_design:
            grad = beta * jnp.einsum("tn,tnd->nd", d1, Phi)
            negH = -beta * jnp.einsum("tn,tnd,tne->nde", d2, Phi, Phi)
        else:
            grad = beta * jnp.einsum("tn,td->nd", d1, Phi)
            negH = -beta * jnp.einsum("tn,td,te->nde", d2, Phi, Phi)
        grad = grad - (theta - prior_mu) * prior_prec
        negH = negH + jax.vmap(jnp.diag)(prior_prec)
        return grad, negH

    def newton(theta, _):
        g, nH = grad_negH(theta)
        return theta + jnp.linalg.solve(nH, g[..., None])[..., 0], None

    theta_star, _ = jax.lax.scan(newton, theta0, None, length=n_newton)
    _, negH = grad_negH(theta_star)
    C = jnp.linalg.cholesky(negH)  # (N, D, D) lower, C Cᵀ = −H*
    log_det_C = jnp.sum(jnp.log(jnp.diagonal(C, axis1=1, axis2=2)), axis=1)

    # DEFENSIVE MIXTURE (same disease and cure as the birth–death weight
    # proposal above): an independence proposal with lighter tails than
    # the target cannot leave a remote state — from θ_cur hundreds of
    # prior sds out (e.g. a pathological init, or a softplus model whose
    # stabilized LL stays FINITE and nearly flat at very negative
    # currents), q(θ_cur) ~ e^{−10⁵} while π(θ_cur) ~ e^{−10⁴}, so the
    # exact MH rejects every exit forever. Mixing 10 % of the PRIOR into
    # the proposal bounds the reverse density by 0.1·prior(θ_cur), which
    # cancels the prior term of π(θ_cur) in the ratio and lets the chain
    # escape in one accepted draw. Normal operation is unaffected (the
    # ratio absorbs the mixture exactly; acceptance stays near 1).
    k_z, k_u, k_mix = jax.random.split(key, 3)
    z = jax.random.normal(k_z, (N, D), f)
    # θ' = θ* + C⁻ᵀ z  ⇒  cov = C⁻ᵀ C⁻¹ = (−H*)⁻¹
    delta = jax.vmap(
        lambda Cn, zn: jax.scipy.linalg.solve_triangular(Cn.T, zn, lower=False)
    )(C, z)
    use_hat = jax.random.uniform(k_mix, (N,), f) < 0.9
    # z is reused across the mutually exclusive branches — each branch
    # alone is the correct marginal draw
    theta_prop = jnp.where(
        use_hat[:, None], theta_star + delta, prior_mu + prior_sd * z
    )

    _HALF_LOG2PI = 0.9189385332046727

    def log_q(theta):
        r = jnp.einsum("nij,ni->nj", C, theta - theta_star)  # Cᵀ(θ−θ*)
        lq_hat = log_det_C - 0.5 * jnp.sum(r * r, axis=1) - D * _HALF_LOG2PI
        zp = (theta - prior_mu) / prior_sd
        lq_prior = jnp.sum(
            -0.5 * zp * zp - jnp.log(prior_sd) - _HALF_LOG2PI, axis=1
        )
        return jnp.logaddexp(jnp.log(0.9) + lq_hat, jnp.log(0.1) + lq_prior)

    def log_target(theta):
        I = currents(theta)
        ll = jnp.sum(obs.log_likelihood(S, I, nlin, dt), axis=0)  # (N,)
        zp = (theta - prior_mu) / prior_sd
        return beta * ll - 0.5 * jnp.sum(zp * zp, axis=1)

    t_prop = log_target(theta_prop)
    t_cur = log_target(theta_cur)
    # non-finite current target = escape hatch (accept any finite proposal);
    # non-finite proposal = reject
    t_cur = jnp.where(jnp.isfinite(t_cur), t_cur, -jnp.inf)
    t_prop = jnp.where(jnp.isfinite(t_prop), t_prop, -jnp.inf)
    lq_cur = log_q(theta_cur)
    lq_prop = log_q(theta_prop)
    log_alpha = t_prop - lq_prop - t_cur + lq_cur
    # Escape hatch #2: a non-finite REVERSE density (Laplace fit broken in
    # a way the _bin_ll_derivs sanitizer didn't prevent) makes the exact
    # ratio undefined; rejecting forever is the one un-recoverable choice
    # (the fit is a deterministic function of the fixed data + seed, so it
    # stays broken every sweep). Accept a finite proposal instead and let
    # the next sweep re-fit from a sane state.
    fixable = ~jnp.isfinite(lq_cur) & jnp.isfinite(t_prop - lq_prop)
    log_alpha = jnp.where(fixable, jnp.inf, log_alpha)
    log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
    accept = jnp.log(jax.random.uniform(k_u, (N,), f)) < log_alpha
    theta_new = jnp.where(accept[:, None], theta_prop, theta_cur)
    return theta_new, accept


def _bias_bkgd_scalars(pop):
    """(b_mu, b_sd, s_mu, s_sd) from the spec — the ONE extraction every
    glm Laplace variant uses (defaults match models.zoo). These feed MH
    log-targets, so a drifted copy would silently change the sampled
    posterior, not just a proposal."""
    bspec = pop.spec.get("bias", {})
    kspec = pop.spec.get("bkgd", {})
    return (
        float(bspec.get("mu", 2.0)),
        float(bspec.get("sigma", 1.0)),
        float(kspec.get("mu", 0.0)),
        float(kspec.get("sigma", 1.0)),
    )


def _glm_prior_rows(pop, D):
    """(prior_mu, prior_sd) rows [bias; stimulus-weights×(D−1)]."""
    b_mu, b_sd, s_mu, s_sd = _bias_bkgd_scalars(pop)
    mu = [b_mu] + [s_mu] * (D - 1)
    sd = [b_sd] + [s_sd] * (D - 1)
    return jnp.asarray(mu), jnp.asarray(sd)


def update_glm_laplace(
    key, pop, params, data, theta0, beta=1.0, n_newton: int = 6,
    return_accept: bool = False,
):
    """Laplace independence-MH for the (bias, w_stim) block — any
    observation/nonlinearity, none/basis stimulus (the design is linear:
    φ_t = [1, x_t]). See :func:`_laplace_mh_block` for the mechanism and
    the no-step-size rationale."""
    S, dt = data["S"], pop.dt
    T, N = S.shape
    f = S.dtype
    if "X_stim" in data:
        Phi = jnp.concatenate([jnp.ones((T, 1), f), data["X_stim"].astype(f)], axis=1)
    else:
        Phi = jnp.ones((T, 1), f)
    D = Phi.shape[1]
    prior_mu, prior_sd = _glm_prior_rows(pop, D)

    d = dict(data)
    d["_G"] = pop.coupling(params)
    I0 = pop.impulse.current(params, d)  # (T, N) coupling current

    theta_cur = params["bias"][:, None]
    if D > 1:
        theta_cur = jnp.concatenate([theta_cur, params["w_stim"]], axis=1)

    theta_new, accept = _laplace_mh_block(
        key, S, dt, pop.observation, pop.nlin, I0, Phi, theta_cur, theta0,
        prior_mu, prior_sd, beta=beta, n_newton=n_newton,
    )
    out = {**params, "bias": theta_new[:, 0]}
    if D > 1:
        out["w_stim"] = theta_new[:, 1:]
    if return_accept:
        return out, jnp.mean(accept.astype(f))
    return out


def update_glm_laplace_st(
    key, pop, params, data, theta0, beta=1.0, n_newton: int = 6,
    return_accept: bool = False,
):
    """Laplace independence-MH for the spatiotemporal-stimulus glm block.

    The separable receptive field I_stim[t,n] = Σ_db w_s[n,d]·w_t[n,b]·
    X_st[t,d,b] is BILINEAR in (w_s, w_t), so the block splits into two
    conditionally-linear sub-blocks updated in turn (each an exact MH on
    its conditional, see :func:`_laplace_mh_block`):

      a. θ_n = [bias_n; w_s[n]]  with per-neuron design [1, X_st·w_t[n]],
      b. θ_n = [w_t[n]]          with per-neuron design  X_st·w_s[n]
         (bias enters as an offset).

    ``theta0``: dict with 'bias' (N,), 'w_stim_s' (N,D), 'w_stim_t' (N,B) —
    the state-independent Newton seeds (MAP/init values).
    """
    S, dt = data["S"], pop.dt
    f = S.dtype
    X = data["X_st"].astype(f)  # (T, D, B)
    N = pop.N

    d = dict(data)
    d["_G"] = pop.coupling(params)
    I_coup = pop.impulse.current(params, d)  # (T, N)

    b_mu, b_sd, s_mu, s_sd = _bias_bkgd_scalars(pop)

    k_a, k_b = jax.random.split(key)

    # (a) [bias, w_s] | w_t — design φ[t,n,:] = [1, X_st @ w_t[n]]
    Ds = X.shape[1]
    phi_s = jnp.einsum("tdb,nb->tnd", X, params["w_stim_t"])  # (T,N,D)
    Phi_a = jnp.concatenate(
        [jnp.ones(phi_s.shape[:2] + (1,), f), phi_s], axis=2
    )  # (T,N,1+D)
    th_cur = jnp.concatenate([params["bias"][:, None], params["w_stim_s"]], axis=1)
    th0 = jnp.concatenate([theta0["bias"][:, None], theta0["w_stim_s"]], axis=1)
    mu_a = jnp.asarray([b_mu] + [s_mu] * Ds)
    sd_a = jnp.asarray([b_sd] + [s_sd] * Ds)
    th_new, acc_a = _laplace_mh_block(
        k_a, S, dt, pop.observation, pop.nlin, I_coup, Phi_a, th_cur, th0,
        mu_a, sd_a, beta=beta, n_newton=n_newton,
    )
    params = {**params, "bias": th_new[:, 0], "w_stim_s": th_new[:, 1:]}

    # (b) w_t | [bias, w_s] — design φ[t,n,:] = X_stᵀ @ w_s[n]; bias offsets
    phi_t = jnp.einsum("tdb,nd->tnb", X, params["w_stim_s"])  # (T,N,B)
    I0_b = I_coup + params["bias"][None, :]
    th_new, acc_b = _laplace_mh_block(
        k_b, S, dt, pop.observation, pop.nlin, I0_b, phi_t,
        params["w_stim_t"], theta0["w_stim_t"],
        jnp.asarray(s_mu), jnp.asarray(s_sd), beta=beta, n_newton=n_newton,
    )
    params = {**params, "w_stim_t": th_new}
    if return_accept:
        return params, 0.5 * (jnp.mean(acc_a.astype(f)) + jnp.mean(acc_b.astype(f)))
    return params


def update_glm_laplace_shared(
    key, pop, params, data, theta0, beta=1.0, n_newton: int = 6,
    return_accept: bool = False,
):
    """Laplace independence-MH for the shared-tuning-curve glm block.

    The shared stimulus current I_stim[t,n] = gain_n · (x_tᵀ w_shared)
    couples all neurons through the GLOBAL filter w_shared, breaking the
    per-neuron factorization. The block splits into

      a. per-neuron θ_n = [bias_n; gain_n] given w_shared — linear with
         design [1, x_tᵀ w_shared] (:func:`_laplace_mh_block`), and
      b. the global DB-dim w_shared given (bias, gain) — one pooled Newton
         over all neurons (grad Σ_tn f'·gain_n x_t, Hessian
         Σ_tn f''·gain_n² x_t x_tᵀ) with a single MH accept.
    """
    S, dt = data["S"], pop.dt
    obs, nlin = pop.observation, pop.nlin
    f = S.dtype
    X = data["X_stim"].astype(f)  # (T, DB)
    DB = X.shape[1]

    d = dict(data)
    d["_G"] = pop.coupling(params)
    I_coup = pop.impulse.current(params, d)  # (T, N)

    b_mu, b_sd, s_mu, s_sd = _bias_bkgd_scalars(pop)
    # gain prior: single source of truth in the component definition
    from theano_pyglm_tpu.models.components import GAIN_PRIOR_MU, GAIN_PRIOR_SD

    g_mu, g_sd = GAIN_PRIOR_MU, GAIN_PRIOR_SD

    k_a, k_b, k_u = jax.random.split(key, 3)

    # (a) per-neuron [bias, gain] | w_shared
    drive = X @ params["w_stim_shared"]  # (T,)
    Phi_a = jnp.stack([jnp.ones_like(drive), drive], axis=1)  # (T, 2)
    th_cur = jnp.stack([params["bias"], params["gain"]], axis=1)
    th0 = jnp.stack([theta0["bias"], theta0["gain"]], axis=1)
    th_new, acc_a = _laplace_mh_block(
        k_a, S, dt, obs, nlin, I_coup, Phi_a, th_cur, th0,
        jnp.asarray([b_mu, g_mu]), jnp.asarray([b_sd, g_sd]),
        beta=beta, n_newton=n_newton,
    )
    params = {**params, "bias": th_new[:, 0], "gain": th_new[:, 1]}

    # (b) global w_shared | (bias, gain): pooled concave GLM over all bins
    # of all neurons; one Newton + one MH accept for the DB-vector.
    I0 = I_coup + params["bias"][None, :]
    gain = params["gain"]
    prior_prec = 1.0 / (s_sd * s_sd)

    def grad_negH(w):  # (DB,) -> ((DB,), (DB,DB))
        I = I0 + drive_of(w)
        d1, d2 = _bin_ll_derivs(S, I, obs, nlin, dt)
        d2 = jnp.minimum(d2, 0.0)
        # Σ_tn d1·gain_n x_t ; Σ_tn (−d2)·gain_n² x_t x_tᵀ
        g_vec = beta * (X.T @ (d1 @ gain)) - (w - s_mu) * prior_prec
        r = -d2 @ (gain * gain)  # (T,)
        nH = beta * jnp.einsum("t,td,te->de", r, X, X) + prior_prec * jnp.eye(DB, dtype=f)
        return g_vec, nH

    def drive_of(w):
        return (X @ w)[:, None] * gain[None, :]

    def newton(w, _):
        g_vec, nH = grad_negH(w)
        return w + jnp.linalg.solve(nH, g_vec), None

    w_star, _ = jax.lax.scan(newton, theta0["w_stim_shared"], None, length=n_newton)
    _, nH = grad_negH(w_star)
    C = jnp.linalg.cholesky(nH)
    log_det_C = jnp.sum(jnp.log(jnp.diag(C)))
    _HALF_LOG2PI = 0.9189385332046727

    # DEFENSIVE MIXTURE — same disease and cure as _laplace_mh_block and
    # the birth–death weight proposal: until round 4 this was the one
    # remaining PURE Laplace independence proposal in the codebase, so a
    # remote w_shared state (pathological init; a softplus model whose
    # stabilized LL stays finite and nearly flat at very negative currents)
    # could drive the reverse density q(w_cur) to e^{−10⁵} while
    # π(w_cur) ~ e^{−10⁴} and freeze the GLOBAL filter forever — masked in
    # practice because the per-neuron (bias, gain) sub-block keeps moving.
    # Mixing 10 % of the prior into the proposal bounds the reverse density
    # by 0.1·prior(w_cur), which cancels the prior term of π(w_cur) in the
    # ratio and lets the chain escape in one accepted draw.
    k_z, k_mix = jax.random.split(k_b)
    z = jax.random.normal(k_z, (DB,), f)
    delta = jax.scipy.linalg.solve_triangular(C.T, z, lower=False)
    use_hat = jax.random.uniform(k_mix, (), f) < 0.9
    # z reused across the mutually exclusive branches — each branch alone
    # is the correct marginal draw
    w_prop = jnp.where(use_hat, w_star + delta, s_mu + s_sd * z)

    def log_q(w):
        r = C.T @ (w - w_star)
        lq_hat = log_det_C - 0.5 * jnp.sum(r * r) - DB * _HALF_LOG2PI
        zp = (w - s_mu) / s_sd
        lq_prior = -0.5 * jnp.sum(zp * zp) - DB * (jnp.log(jnp.asarray(s_sd, f)) + _HALF_LOG2PI)
        return jnp.logaddexp(jnp.log(0.9) + lq_hat, jnp.log(0.1) + lq_prior)

    def log_target(w):
        ll = jnp.sum(obs.log_likelihood(S, I0 + drive_of(w), nlin, dt))
        zp = (w - s_mu) / s_sd
        return beta * ll - 0.5 * jnp.sum(zp * zp)

    t_prop, t_cur = log_target(w_prop), log_target(params["w_stim_shared"])
    t_cur = jnp.where(jnp.isfinite(t_cur), t_cur, -jnp.inf)
    t_prop = jnp.where(jnp.isfinite(t_prop), t_prop, -jnp.inf)
    lq_prop, lq_cur = log_q(w_prop), log_q(params["w_stim_shared"])
    log_alpha = t_prop - lq_prop - t_cur + lq_cur
    # non-finite REVERSE density hatch (mirrors _laplace_mh_block): the fit
    # is a deterministic function of the fixed data + seed, so a broken one
    # stays broken every sweep — accept a finite proposal rather than
    # reject forever.
    fixable = ~jnp.isfinite(lq_cur) & jnp.isfinite(t_prop - lq_prop)
    log_alpha = jnp.where(fixable, jnp.inf, log_alpha)
    log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
    acc_b = jnp.log(jax.random.uniform(k_u, (), f)) < log_alpha
    w_new = jnp.where(acc_b, w_prop, params["w_stim_shared"])
    params = {**params, "w_stim_shared": w_new}
    if return_accept:
        return params, 0.5 * (jnp.mean(acc_a.astype(f)) + acc_b.astype(f))
    return params


def refresh_disconnected_weights(key, pop, params):
    """Resample W[n,m] | A[n,m]=0 from its prior (the exact conditional)."""
    if not pop.weights.has_W:
        return params
    MU, SIG = pop.weights.prior_mu_sigma(params)
    W_prior = MU + SIG * jax.random.normal(key, params["W"].shape)
    W = jnp.where(params["A"] > 0, params["W"], W_prior)
    return {**params, "W": W}


def update_sbm_types(key, pop, params):
    """Sequential Gibbs over SBM type assignments y_n (scan over neurons,
    vectorized over the K classes):

    p(y_n=k | rest) ∝ π_k · Π_{m≠n} B[k,y_m]^{A_nm}(1-·)^{1-A_nm}
                         · Π_{m≠n} B[y_m,k]^{A_mn}(1-·)^{1-A_mn}
                         · B[k,k]^{A_nn}(1-·)^{1-A_nn}
    """
    if pop.graph.name != "sbm":
        return params
    A, y, pi, Bm = params["A"], params["y"], params["pi"], params["Bm"]
    N, K = pop.N, Bm.shape[0]
    logB1 = jnp.log(jnp.clip(Bm, 1e-12, 1.0))
    logB0 = jnp.log(jnp.clip(1.0 - Bm, 1e-12, 1.0))
    log_pi = jnp.log(jnp.clip(pi, 1e-12, 1.0))

    def step(y, inp):
        n, k_n = inp
        onehot_m = jax.nn.one_hot(y, K)  # (N, K) current assignments
        # out-edges n→·  (row n of A uses B[k, y_m]); mask self term
        mask = (jnp.arange(N) != n).astype(A.dtype)
        a_out, a_in = A[n, :], A[:, n]
        # (K,) log-lik of row/col under candidate class k
        ll_out = (mask * a_out) @ onehot_m @ logB1.T + (mask * (1 - a_out)) @ onehot_m @ logB0.T
        ll_in = (mask * a_in) @ onehot_m @ logB1 + (mask * (1 - a_in)) @ onehot_m @ logB0
        ll_self = A[n, n] * jnp.diag(logB1) + (1.0 - A[n, n]) * jnp.diag(logB0)
        logits = log_pi + ll_out + ll_in + ll_self
        y_n = jax.random.categorical(k_n, logits)
        return y.at[n].set(y_n), None

    keys = jax.random.split(key, N)
    y_new, _ = jax.lax.scan(step, y, (jnp.arange(N), keys))
    return {**params, "y": y_new}


def update_sbm_types_collapsed(key, pop, params):
    """Collapsed sequential Gibbs over SBM types: π and B marginalized
    analytically (Dirichlet–multinomial over class counts, Beta–Bernoulli
    over each block's edge counts), scan over neurons:

    p(y_n=k | y_−n, A) ∝ (α0 + c_k) · Π_blocks  B(b0+e', b1+p'−e')
                                                ─────────────────────
                                                B(b0+e,  b1+p −e)

    where (e, p) → (e', p') adds neuron n's edges/pairs into the blocks of
    row k and column k (and the self-pair into block (k,k)).

    WHY this replaces :func:`update_sbm_types` in the sweep: the
    uncollapsed update conditions on a B that has conjugately adapted to
    the *current* partial assignment, so a chain parked in a local mode of
    the type posterior has exponentially small exit probability under
    single-site moves (observed: acceptance config-4 chains parked at
    ARI 0.749 across rounds, surviving even annealed warmup). Marginalizing
    (π, B) re-evaluates the whole block evidence for every candidate class,
    which restores single-site mobility between assignments.

    Exactness in the sweep (partially collapsed Gibbs, van Dyk & Park):
    this kernel draws y_n from the exact conditional of the MARGINAL model
    p(y, A, …); it is valid in the sweep because
    :func:`update_sbm_hypers` redraws (π, B) from their full conditional
    immediately afterwards, before any other stage reads them. Verified by
    the exact-enumeration TV test (tests/test_gibbs.py) and the SBM Geweke.
    """
    if pop.graph.name != "sbm":
        return params
    spec = pop.spec["network"]["graph"]
    A, y = params["A"], params["y"]
    N, K = pop.N, params["Bm"].shape[0]
    alpha0 = float(spec.get("alpha0", 1.0))
    b0, b1 = [float(v) for v in spec.get("B_prior", (1.0, 1.0))]
    betaln = jax.scipy.special.betaln
    eyeK = jnp.eye(K)
    f = A.dtype

    def step(y, inp):
        n, k_n = inp
        mask = (jnp.arange(N) != n).astype(f)
        onehot = jax.nn.one_hot(y, K, dtype=f) * mask[:, None]  # n excluded
        cnt = onehot.sum(axis=0)                                # (K,)
        # block edge/pair counts over ordered pairs NOT involving n
        # (onehot's zeroed row n drops them on both sides of A)
        E = onehot.T @ A @ onehot                               # (K, K)
        P = jnp.outer(cnt, cnt)
        eo = (A[n] * mask) @ onehot                             # n→class edges
        ei = (A[:, n] * mask) @ onehot                          # class→n edges
        a_nn = A[n, n]
        # candidate axis c: row c gains (eo, cnt), column c gains (ei, cnt),
        # block (c, c) additionally gains the self-pair (a_nn, 1)
        dE = (
            eyeK[:, :, None] * eo[None, None, :]      # block (c, j) += eo[j]
            + eyeK[:, None, :] * ei[None, :, None]    # block (i, c) += ei[i]
            + (eyeK[:, :, None] * eyeK[:, None, :]) * a_nn   # (c, c) += self
        )  # (K, K, K): [candidate, block_row, block_col]
        dP = (
            eyeK[:, :, None] * cnt[None, None, :]     # block (c, j) += cnt[j]
            + eyeK[:, None, :] * cnt[None, :, None]   # block (i, c) += cnt[i]
            + eyeK[:, :, None] * eyeK[:, None, :]     # (c, c) += self-pair
        )
        base = betaln(b0 + E, b1 + (P - E))                     # (K, K)
        new = betaln(b0 + E[None] + dE, b1 + (P[None] + dP) - (E[None] + dE))
        dll = jnp.sum(new - base[None], axis=(1, 2))            # (K,)
        logits = jnp.log(alpha0 + cnt) + dll
        y_n = jax.random.categorical(k_n, logits)
        return y.at[n].set(y_n), None

    keys = jax.random.split(key, N)
    y_new, _ = jax.lax.scan(step, y, (jnp.arange(N), keys))
    return {**params, "y": y_new}


def update_sbm_hypers(key, pop, params):
    """Conjugate resampling: π | y ~ Dir(α0 + counts);
    B[k,k'] | A, y ~ Beta(b0 + edges, b1 + pairs − edges)."""
    if pop.graph.name != "sbm":
        return params
    spec = pop.spec["network"]["graph"]
    K = int(spec.get("K", 2))
    alpha0 = float(spec.get("alpha0", 1.0))
    b0, b1 = [float(v) for v in spec.get("B_prior", (1.0, 1.0))]
    A, y = params["A"], params["y"]

    k1, k2 = jax.random.split(key)
    onehot = jax.nn.one_hot(y, K)  # (N, K)
    counts = jnp.sum(onehot, axis=0)
    pi = jax.random.dirichlet(k1, alpha0 + counts)

    edges = onehot.T @ A @ onehot  # (K, K) edge counts between blocks
    pairs = jnp.outer(counts, counts)
    Bm = jax.random.beta(k2, b0 + edges, b1 + (pairs - edges))
    Bm = jnp.clip(Bm, 1e-6, 1.0 - 1e-6)
    return {**params, "pi": pi, "Bm": Bm}


def update_weight_hypers(key, pop, params):
    """Conjugate Normal–Inverse-Gamma resampling of the off-diagonal weight
    prior's (μ_W, σ_W²) given all off-diagonal W entries (the slab applies to
    every entry — disconnected weights are prior draws and carry hyper
    information in the joint model). Active when the weight spec sets
    ``infer_hypers`` (≅ reference's conjugate hyper updates, SURVEY.md §2)."""
    if pop.weights.name != "gaussian" or "W_mu" not in params:
        return params
    wspec = pop.spec["network"]["weight"]
    m0, k0 = float(wspec.get("m0", 0.0)), float(wspec.get("k0", 1.0))
    a0, b0 = float(wspec.get("a0", 2.0)), float(wspec.get("b0", 2.0))

    N = pop.N
    off = 1.0 - jnp.eye(N)
    w = params["W"]
    n = N * (N - 1)
    wbar = jnp.sum(w * off) / n
    ss = jnp.sum(off * (w - wbar) ** 2)

    k_n = k0 + n
    m_n = (k0 * m0 + n * wbar) / k_n
    a_n = a0 + n / 2.0
    b_n = b0 + 0.5 * ss + k0 * n * (wbar - m0) ** 2 / (2.0 * k_n)

    k1, k2 = jax.random.split(key)
    var = b_n / jax.random.gamma(k1, a_n)
    mu_new = m_n + jnp.sqrt(var / k_n) * jax.random.normal(k2)
    return {**params, "W_mu": mu_new, "W_sigma": jnp.sqrt(var)}


def update_er_rho(key, pop, params):
    """Conjugate Beta update of the Erdős–Rényi density (when inferred)."""
    if pop.graph.name != "erdos_renyi" or "rho" not in params:
        return params
    spec = pop.spec["network"]["graph"]
    a0, b0 = [float(v) for v in spec.get("rho_prior", (1.0, 1.0))]
    A = params["A"]
    n_edges = jnp.sum(A)
    n_total = A.size
    rho = jax.random.beta(key, a0 + n_edges, b0 + (n_total - n_edges))
    return {**params, "rho": jnp.clip(rho, 1e-6, 1.0 - 1e-6)}


def update_latent_rotation(key, pop, params):
    """Haar orthogonal Gibbs move on the latent locations (distance graph).

    The distance model's posterior is exactly invariant under a rigid
    rotation/reflection of all locations about the prior center: the edge
    logits depend on the locations only through pairwise squared distances
    (``models/network.py`` ``_logits``) and the prior is isotropic
    N(0, σ_ℓ² I), so π(ℓQ | rest) = π(ℓ | rest) for every orthogonal Q.
    Proposing ℓ → ℓQ with Q ~ Haar(O(D)) is therefore an MH move whose
    acceptance ratio is exactly 1 — a Gibbs draw on the orientation gauge.

    Why it exists: the likelihood has ZERO gradient along this orbit, so
    the latent HMC block random-walks the orientation under the (invariant)
    prior alone — the slowest direction in the flagship posterior (raw-
    coordinate locs ESS ≈ 225 vs ≥ 990 on every other group, round 3). One
    Haar draw per sweep mixes the orbit in a single step. Identifiable
    functions of the locations — pairwise distances, edge probabilities,
    link-prediction AUC — are untouched; raw-coordinate posteriors become
    honestly orientation-averaged (plot draws through a Procrustes
    alignment, ``plotting.procrustes_align``).

    Haar on O(2) (the default D) is uniform angle × reflection coin, closed
    form — no QR in the jitted sweep; general D uses QR of a Gaussian matrix
    with the R-diagonal sign fix (Stewart 1980), the standard construction.
    """
    if pop.graph.name != "distance" or "locs" not in params:
        return params
    locs = params["locs"]
    D = locs.shape[-1]
    if D == 2:
        k1, k2 = jax.random.split(key)
        th = jax.random.uniform(k1, (), locs.dtype, 0.0, 2.0 * jnp.pi)
        refl = jnp.where(jax.random.bernoulli(k2), 1.0, -1.0).astype(locs.dtype)
        c, s = jnp.cos(th), jnp.sin(th)
        # rotation by th, times diag(1, refl): second column sign carries the coin
        Qm = jnp.stack([jnp.stack([c, -s * refl]), jnp.stack([s, c * refl])])
    else:
        G = jax.random.normal(key, (D, D), dtype=locs.dtype)
        Qm, R = jnp.linalg.qr(G)
        Qm = Qm * jnp.sign(jnp.diagonal(R))[None, :]
    return {**params, "locs": locs @ Qm}
