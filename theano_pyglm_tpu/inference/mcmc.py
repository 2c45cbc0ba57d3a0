"""MCMC driver — the update-sweep loop (≅ ``gibbs_sample`` in the reference).

Rebuild of ``pyglm/inference/gibbs.py``'s outer loop (SURVEY.md §3.3): each
iteration interleaves
  1. HMC per continuous block — (bias, stimulus gains), (impulse logits),
     (latent locations) — each with its own dual-averaged step size and
     Welford diagonal preconditioner (the reference likewise updates each
     component group separately),
  2. conjugate weight-hyperparameter resampling + prior refresh of
     disconnected weights (exact conditionals),
  3. the row-parallel joint (A, W) birth–death sweep over the adjacency
     matrix (W is owned by this move, not HMC — see _HMC_BLOCKS),
  4. discrete Gibbs over SBM types + conjugate Beta/Dirichlet hyper updates
     (or the conjugate Erdős–Rényi density update).

Where the reference's loop is a Python ``for`` over compiled Theano thunks
with periodic pickle dumps, here the whole sweep is ONE jitted function and
iterations run device-side in ``lax.scan`` chunks; thinned samples stream
back to host numpy per chunk (bounded device memory). Warmup follows Stan-style
expanding adaptation windows (see :func:`warmup_schedule`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from theano_pyglm_tpu.inference.gibbs import (
    refresh_disconnected_weights,
    update_adjacency,
    update_adjacency_collapsed,
    update_er_rho,
    update_glm_laplace,
    update_glm_laplace_shared,
    update_glm_laplace_st,
    update_latent_rotation,
    update_sbm_hypers,
    update_sbm_types_collapsed,
    update_weight_hypers,
)
from theano_pyglm_tpu.inference.hmc import (
    HMCState,
    apply_mass_matrix,
    hmc_adaptive_step,
    reset_variance,
)
from theano_pyglm_tpu.utils.dtypes import default_float, full_precision_matmuls

__all__ = [
    "SWEEP_STAGES",
    "make_sweep",
    "gibbs_sample",
    "init_mcmc_state",
    "warmup_schedule",
    "anneal_schedule",
    "adapt_boundary",
]


def _glm_theta0(pop, data, fisher_params, bk_type):
    """State-independent Newton seed for the glm Laplace-MH block: the
    init/MAP values if available, else the prior means. Shape depends on
    the stimulus variant: (N, D) array for none/basis, a dict of the
    block's leaves for spatiotemporal/shared."""
    f = default_float()
    N = pop.N
    bmu = float(pop.spec.get("bias", {}).get("mu", 2.0))
    smu = float(pop.spec.get("bkgd", {}).get("mu", 0.0))
    have = fisher_params is not None and "bias" in fisher_params

    def leaf(name, default):
        if have and name in fisher_params:
            return jnp.asarray(fisher_params[name], f)
        return default

    if bk_type in ("none", "basis"):
        D = 1 + (data["X_stim"].shape[1] if "X_stim" in data else 0)
        if have:
            th = leaf("bias", None)[:, None]
            if D > 1:
                th = jnp.concatenate([th, leaf("w_stim", None)], axis=1)
            return th
        row = jnp.asarray([bmu] + [smu] * (D - 1), f)
        return jnp.broadcast_to(row, (N, D))
    if bk_type == "spatiotemporal":
        Ds, B = data["X_st"].shape[1], data["X_st"].shape[2]
        return {
            "bias": leaf("bias", jnp.full((N,), bmu, f)),
            "w_stim_s": leaf("w_stim_s", jnp.full((N, Ds), smu, f)),
            "w_stim_t": leaf("w_stim_t", jnp.full((N, B), smu, f)),
        }
    if bk_type == "shared":
        DB = data["X_stim"].shape[1]
        return {
            "bias": leaf("bias", jnp.full((N,), bmu, f)),
            "gain": leaf("gain", jnp.ones((N,), f)),
            "w_stim_shared": leaf("w_stim_shared", jnp.full((DB,), smu, f)),
        }
    raise ValueError(f"unknown bkgd type {bk_type!r}")


def warmup_schedule(n_warmup: int):
    """Stan-style expanding warmup windows:
    [0,b1) ε-only · [b1,b2) variance window 1 · apply+reset at b2 ·
    [b2,b3) variance window 2 (now well-preconditioned and mixing) ·
    apply at b3 · [b3,n) final ε adaptation. Mass adaptation is skipped for
    very short warmups (the windows would be too noisy)."""
    if n_warmup < 40:
        return []
    b1 = max(1, int(0.15 * n_warmup))
    b2 = max(b1 + 1, int(0.50 * n_warmup))
    b3 = max(b2 + 1, int(0.85 * n_warmup))
    return [(b1, "reset"), (b2, "apply_reset"), (b3, "apply")]


def warmup_chunk(n_warmup: int, boundaries, chunk_size: int) -> int:
    """One scan length for the whole warmup phase.

    The chunk runner jit-compiles per STATIC chunk length, and the greedy
    ``min(chunk_size, next_boundary - it)`` chunking of a boundaried warmup
    produces several distinct remainders — e.g. n_warmup=1000, chunk 250,
    boundaries {150, 500, 850} → lengths {150, 250, 100}: three separate
    XLA compiles of the full sweep scan, each of which costs far more than
    a host dispatch. Returns the largest c ≤ chunk_size dividing every
    adaptation segment, so every warmup chunk is exactly c and the phase
    compiles ONE program at the price of a few extra dispatches. With no
    boundaries the
    same rule folds the final-remainder chunk away (n_warmup=30, chunk 25
    → one 15-length program instead of {25, 5}). Falls back to
    ``chunk_size`` (greedy behaviour) if uniformity would need c <
    chunk_size/10 — a pathological boundary layout where the dispatch
    overhead could rival a compile.

    NOTE: chunk layout feeds the per-chunk PRNG split, so this choice is
    part of the (deterministic) sampler configuration: changing it changes
    trajectories — exactly like changing ``chunk_size`` always has — but
    resume stays exact because the layout is a pure function of
    (n_warmup, boundaries, chunk_size).
    """
    import math

    stops = sorted({n_warmup, *[b for b, _ in boundaries if 0 < b < n_warmup]})
    g, prev = 0, 0
    for b in stops:
        g, prev = math.gcd(g, b - prev), b
    if g == 0:
        return chunk_size
    c = next((d for d in range(min(chunk_size, g), 0, -1) if g % d == 0), 1)
    return c if c * 10 >= chunk_size else chunk_size


def sampling_chunk(total: int, chunk_size: int, thin: int = 1) -> int:
    """Uniform chunk length for the (boundary-free) sampling phase: the
    largest c ≤ chunk_size dividing ``total`` — so the final-remainder chunk
    never compiles a second scan program — preferring multiples of ``thin``
    so every chunk keeps the on-device thinning path (a c that breaks the
    thin|c alignment would silently fall back to collect-every-sweep and
    re-inflate the host transfer the device thinning removed). Same
    fallback-to-greedy rule as :func:`warmup_chunk`."""
    if thin > 1 and chunk_size >= thin and total % thin == 0:
        base = warmup_chunk(total // thin, (), chunk_size // thin)
        if (total // thin) % base == 0:
            return base * thin
    return warmup_chunk(total, (), chunk_size)


def adapt_boundary(state: dict, action: str) -> dict:
    """Apply a warmup-window boundary action to every HMC block (works on
    chain-batched states too — all ops are elementwise on the leaves)."""

    def fn(s):
        if action == "reset":
            return reset_variance(s)
        if action == "apply_reset":
            return reset_variance(apply_mass_matrix(s))
        return apply_mass_matrix(s)

    out = dict(state)
    for k, _ in _HMC_BLOCKS:
        if k in out:
            out[k] = fn(out[k])
    return out

# HMC runs in separate blocks per component group (as the reference's Gibbs
# loop does, SURVEY.md §3.3) — each block gets its own step size and diagonal
# preconditioner. Mixing sharply- and diffusely-scaled groups under one ε
# pins it at the sharpest direction and stalls everything else. W is in NO
# block: the birth-death move re-proposes every (A, W) entry from a Laplace
# approximation of its exact conditional each sweep (near-iid mixing), and a
# spike-and-slab marginal would poison any Welford preconditioner.
_HMC_BLOCKS = (
    ("glm", ("bias", "w_stim", "w_stim_s", "w_stim_t", "w_stim_shared", "gain")),
    ("imp", ("w_ir",)),
    ("latent", ("locs",)),
)
_GLM_KEYS = tuple(k for _, ks in _HMC_BLOCKS for k in ks)
_LATENT_KEYS = ("locs",)


def _partition(params, keys):
    inblock = {k: v for k, v in params.items() if k in keys}
    rest = {k: v for k, v in params.items() if k not in keys}
    return inblock, rest


def _fresh_block_state(prev: HMCState, position, log_prob) -> HMCState:
    """Reuse step-size adaptation stats, re-anchor position/log-prob (the
    frozen complement changed since the last sweep, so cached log_p is stale).
    """
    return HMCState(
        position=position,
        log_prob=log_prob,
        step_size=prev.step_size,
        log_eps_avg=prev.log_eps_avg,
        h_avg=prev.h_avg,
        t=prev.t,
        accept_rate=prev.accept_rate,
        mu=prev.mu,
        scale=prev.scale,
        pos_mean=prev.pos_mean,
        pos_m2=prev.pos_m2,
        n_var=prev.n_var,
    )


def init_mcmc_state(pop, params, step_size: float = 0.02) -> dict:
    """Build the MCMC carry: params + one HMCState per continuous block.

    Positions are seeded with the matching parameter partition so the carry
    pytree structure is already what the sweep produces (scan-stable); the
    cached log_prob is a placeholder — the sweep re-anchors it every
    iteration anyway.
    """
    f = default_float()
    eps = jnp.asarray(step_size, f)

    def block(position):
        return HMCState(
            position=position,
            log_prob=jnp.asarray(0.0, f),
            step_size=eps,
            log_eps_avg=jnp.log(eps),
            h_avg=jnp.asarray(0.0, f),
            t=jnp.asarray(0.0, f),
            accept_rate=jnp.asarray(1.0, f),
            mu=jnp.log(10.0 * eps),
            scale=jax.tree.map(jnp.ones_like, position),
            pos_mean=jax.tree.map(jnp.zeros_like, position),
            pos_m2=jax.tree.map(jnp.zeros_like, position),
            n_var=jnp.asarray(0.0, f),
        )

    state = {"params": params}
    for name, keys in _HMC_BLOCKS:
        pos, _ = _partition(params, keys)
        if pos:
            state[name] = block(pos)
    return state


#: update groups accepted by ``make_sweep(stages=...)`` — the three HMC/
#: Laplace blocks plus the discrete/conjugate stages, in sweep order.
SWEEP_STAGES = ("glm", "imp", "latent", "hypers", "adjacency", "discrete", "rotation")


def make_sweep(pop, data, n_leapfrog: int = 10, target_accept: float = 0.9,
               row_batch=None, fisher_params: Optional[dict] = None,
               glm_update: str = "auto", stages=None,
               diagnostic: bool = False):
    """Build the jitted one-iteration Gibbs sweep (see module docstring).

    Returns ``sweep(key, state, adapt) -> state`` with ``adapt`` a traced
    bool enabling step-size adaptation (warmup).

    ``row_batch``: stream the adjacency sweep ``row_batch`` postsynaptic
    rows at a time (lax.map) instead of all-at-once (vmap) — bounds the ψ
    working set to row_batch·T·N for long recordings (SURVEY.md §5
    long-context row).

    ``fisher_params``: parameters at which the glm Laplace block seeds its
    Newton iterations (state-independent); typically the MAP/smart init.

    ``glm_update``: 'auto' (default — the Laplace independence-MH below),
    or 'hmc' to force the whitened-HMC fallback on the glm block (kept for
    A/B diagnostics and its Geweke stationarity test).

    ``stages``: optional subset of :data:`SWEEP_STAGES` to run — the other
    update groups are skipped (their state passes through unchanged). For
    per-stage timing (``benchmarks/sweep_profile.py``) and A/B diagnostics
    ONLY: a partial sweep is not a valid posterior kernel — e.g. the
    adjacency birth–death move is exact only because the ``hypers`` stage
    re-draws disconnected W from the prior every sweep
    (:func:`~theano_pyglm_tpu.inference.gibbs.refresh_disconnected_weights`),
    and an ``infer_hypers`` model whose sweep omits ``hypers`` samples a
    different joint. A strict subset therefore requires ``diagnostic=True``
    as an explicit acknowledgment; without it ``make_sweep`` raises rather
    than silently building a non-invariant kernel (round-3 verdict #9).
    """
    if stages is not None:
        unknown = set(stages) - set(SWEEP_STAGES)
        if unknown:
            raise ValueError(f"unknown sweep stages {sorted(unknown)}")
        if set(stages) != set(SWEEP_STAGES) and not diagnostic:
            raise ValueError(
                "make_sweep(stages=...) with a strict subset of "
                f"SWEEP_STAGES {sorted(set(SWEEP_STAGES) - set(stages))} "
                "omitted builds a PARTIAL sweep that is not a valid "
                "posterior kernel (e.g. adjacency depends on the hypers "
                "stage's disconnected-weight refresh). Pass "
                "diagnostic=True if this is for per-stage timing or A/B "
                "diagnostics only."
            )

    def _on(stage):
        return stages is None or stage in stages
    # The glm (bias, stimulus) block is sampled by Laplace independence-MH
    # (gibbs.update_glm_laplace / _st / _shared): Newton to the per-neuron
    # conditional mode, Gaussian proposal at the mode, exact MH — with no
    # step size anywhere. HMC on this block is structurally fragile: the
    # per-neuron Fisher spans orders of magnitude (rate-dependent), pinning
    # a global ε at ~1e-4 where chains move microscopically (round-2
    # flagship: R̂ in the millions from chains parked at their inits).
    # All stimulus variants and observation/nonlinearity pairs are covered
    # (generic elementwise-autodiff curvature, gibbs._bin_ll_derivs);
    # glm_update='hmc' restores the whitened-HMC path.
    if glm_update not in ("auto", "laplace", "hmc"):
        raise ValueError(f"unknown glm_update {glm_update!r}")
    glm_laplace = glm_update != "hmc"
    bk_type = pop.spec.get("bkgd", {}).get("type", "none")
    theta0 = None
    if glm_laplace:
        theta0 = _glm_theta0(pop, data, fisher_params, bk_type)
        glm_laplace_fn = {
            "none": update_glm_laplace,
            "basis": update_glm_laplace,
            "spatiotemporal": update_glm_laplace_st,
            "shared": update_glm_laplace_shared,
        }[bk_type]

    # Whitening substitution for the stimulus weights (HMC fallback only):
    # overlapping basis columns make X_stim's columns strongly correlated,
    # which a diagonal preconditioner cannot fix. The glm block then samples
    # w̃ = w_stim Rᵀ where R = chol(XᵀX/T + λI). Exact change of variables
    # with constant Jacobian; the model/prior are untouched.
    R_inv_T = None
    if "X_stim" in data and not glm_laplace:
        X = data["X_stim"]
        gram = (X.T @ X) / X.shape[0] + 1e-6 * jnp.eye(X.shape[1], dtype=X.dtype)
        R = jnp.linalg.cholesky(gram)
        R_inv_T = jnp.linalg.inv(R).T  # w = w̃ @ R_inv_T ; w̃ = w @ R.T
        R_T = R.T

    def _whiten(opt):
        if R_inv_T is not None and "w_stim" in opt:
            opt = {**opt, "w_stim": opt["w_stim"] @ R_T}
        return opt

    def _dewhiten(opt):
        if R_inv_T is not None and "w_stim" in opt:
            opt = {**opt, "w_stim": opt["w_stim"] @ R_inv_T}
        return opt

    def _sweep(key, state, adapt, beta, data):
        params = state["params"]
        k_blocks, k_wh, k_w, k_a, k_y, k_hyp, k_rho, k_rot = jax.random.split(key, 8)
        block_keys = jax.random.split(k_blocks, len(_HMC_BLOCKS))
        new_state = {}

        # 1–2. HMC per continuous block (own ε and preconditioner each).
        # Each block's log-density drops terms constant within the block and
        # hoists the OTHER blocks' currents out of the leapfrog: the glm
        # block (bias/stimulus) never re-reads the big spike design tensor,
        # so its 2L gradient evals cost only a small matmul + Poisson reduce.
        for (name, keys), k_b in zip(_HMC_BLOCKS, block_keys):
            if name not in state:
                continue
            if not _on(name):
                new_state[name] = state[name]
                continue
            if name == "glm" and glm_laplace:
                params, acc = glm_laplace_fn(
                    k_b, pop, params, data, theta0, beta=beta, return_accept=True
                )
                opt, _ = _partition(params, keys)
                new_state["glm"] = _fresh_block_state(
                    state["glm"], opt, jnp.asarray(0.0, default_float())
                )._replace(accept_rate=acc)
                continue
            opt, frozen = _partition(params, keys)
            if name == "latent":
                # Likelihood doesn't touch the latents; the graph prior does.
                def logp(o, frozen=frozen):
                    return pop.graph.log_prior({**frozen, **o})
            elif name == "glm":
                d_g = dict(data)
                d_g["_G"] = pop.coupling(params)
                I_coupling = pop.impulse.current(params, d_g)
                opt = _whiten(opt)

                def logp(o, frozen=frozen, I_coupling=I_coupling):
                    p = {**frozen, **_dewhiten(o)}
                    I = pop.bias.current(p, data) + pop.bkgd.current(p, data) + I_coupling
                    ll = jnp.sum(
                        pop.observation.log_likelihood(data["S"], I, pop.nlin, pop.dt)
                    )
                    return beta * ll + pop.bias.log_prior(p) + pop.bkgd.log_prior(p)
            else:  # 'imp' — needs the coupling contraction, use the full LL
                def logp(o, frozen=frozen):
                    p = {**frozen, **o}
                    return beta * pop.log_likelihood(p, data) + pop.impulse.log_prior(p)

            h = _fresh_block_state(state[name], opt, logp(opt))
            h = hmc_adaptive_step(
                k_b, logp, h, n_steps=n_leapfrog,
                target_accept=target_accept, adapt=adapt,
            )
            out = _dewhiten(h.position) if name == "glm" else h.position
            params = {**frozen, **out}
            new_state[name] = h

        # 3–5. discrete machinery + conjugate hypers
        if _on("hypers"):
            params = update_weight_hypers(k_wh, pop, params)
            params = refresh_disconnected_weights(k_w, pop, params)
        if _on("adjacency"):
            params = update_adjacency_collapsed(
                k_a, pop, params, data, row_batch=row_batch, beta=beta
            )
        if _on("discrete"):
            # Collapsed over (π, B): single-site type moves stay mobile even
            # when the explicit B has adapted to a partial assignment (the
            # config-4 parked-chain mode); update_sbm_hypers redraws (π, B)
            # right after, keeping the partially collapsed sweep exact.
            params = update_sbm_types_collapsed(k_y, pop, params)
            params = update_sbm_hypers(k_hyp, pop, params)
            params = update_er_rho(k_rho, pop, params)
        # acceptance-1 orientation-gauge draw: mixes the rotation orbit the
        # latent HMC block can only random-walk (zero likelihood gradient
        # along it); exact for the distance graph, no-op otherwise
        if _on("rotation"):
            params = update_latent_rotation(k_rot, pop, params)

        new_state["params"] = params
        return new_state

    def sweep(key, state, adapt, beta=1.0, data=data):
        # ``data`` defaults to the design dict make_sweep closed over, but the
        # chunk runners pass it as a TRACED argument instead: a closure-
        # captured array is inlined into the lowered HLO as a literal, which
        # makes the program grow linearly in T (hundreds of MB of HLO at
        # T=60k) and every compile serialize the design. As an argument the
        # program is O(op-count) and the design stays on device.
        with full_precision_matmuls():
            return _sweep(key, state, adapt, beta, data)

    return sweep


def thin_chunk(samples, thin: int, phase: int):
    """Slice one host chunk onto the *global* thinning grid.

    ``phase`` = sampling iterations completed before this chunk. Keeping
    index i of the chunk iff (phase + i) % thin == thin-1 makes retained
    draws exactly ``thin`` apart across chunk boundaries, for any
    chunk_size/thin combination (the per-chunk ``x[thin-1::thin]`` restarts
    the stride at every boundary and mis-counts when thin ∤ chunk_size).
    """
    if thin <= 1:
        return samples
    start = (thin - 1 - phase) % thin
    return jax.tree.map(lambda x: x[start::thin], samples)


def anneal_schedule(n_warmup: int, anneal_frac: float):
    """Likelihood-tempering warmup schedule: β ramps linearly from ~0 to 1
    over the first ``anneal_frac`` of warmup, then stays at 1. At small β
    the posterior is prior-dominated and nearly flat, so the chain drifts
    freely instead of committing to whichever mode the first few sweeps
    stumbled into — the standard annealing escape for the multimodal
    (A, W, filters) joint (0.0 disables; exactness is untouched because
    sampling always runs at β=1)."""
    if anneal_frac <= 0.0:
        return None
    ramp = max(1, int(round(anneal_frac * n_warmup)))

    def beta_at(it):  # global warmup iteration index
        return min(1.0, (it + 1) / ramp)

    return beta_at


@partial(jax.jit, static_argnums=(0, 1, 5))
def _run_chunk(sweep, n_iters, key, state, adapt, collect_every, betas=None,
               data=None):
    """Run ``n_iters`` sweeps under lax.scan.

    ``collect_every=0`` collects nothing; ``k >= 1`` collects the params
    pytree after sweeps k-1, 2k-1, ... (``k`` must divide ``n_iters`` for
    k > 1). k > 1 thins ON DEVICE via a nested scan, so the device→host
    transfer and the host copies are 1/k of the raw chain. The PRNG stream is identical for every ``collect_every``: one key per
    sweep, consumed in iteration order, so the draws are bit-identical to
    the collect-every-sweep path.

    ``data``: the design dict, passed traced so the lowered program does not
    inline it as an HLO literal (see the note inside ``make_sweep``); with
    ``None`` the sweep falls back to its closure (compat for small models).
    """
    if betas is None:
        betas = jnp.ones((n_iters,))
    run_sweep = (
        sweep if data is None else (lambda k, s, a, b: sweep(k, s, a, b, data))
    )

    def body(carry, inp):
        state, it = carry
        k, beta = inp
        state = run_sweep(k, state, adapt, beta)
        return (state, it + 1), None

    def body_collect(carry, inp):
        state, it = carry
        k, beta = inp
        state = run_sweep(k, state, adapt, beta)
        return (state, it + 1), state["params"]

    keys = jax.random.split(key, n_iters)
    if collect_every == 0:
        (state, _), _ = jax.lax.scan(body, (state, jnp.asarray(0)), (keys, betas))
        return state, None
    if collect_every == 1:
        (state, _), samples = jax.lax.scan(
            body_collect, (state, jnp.asarray(0)), (keys, betas)
        )
        return state, samples
    if n_iters % collect_every:
        raise ValueError(
            f"collect_every={collect_every} must divide n_iters={n_iters}"
        )

    def outer(carry, inp):
        keys_b, betas_b = inp
        carry, _ = jax.lax.scan(body, carry, (keys_b, betas_b))
        return carry, carry[0]["params"]

    n_out = n_iters // collect_every
    (state, _), samples = jax.lax.scan(
        outer,
        (state, jnp.asarray(0)),
        (
            keys.reshape((n_out, collect_every) + keys.shape[1:]),
            betas.reshape(n_out, collect_every),
        ),
    )
    return state, samples


def gibbs_sample(
    pop,
    data,
    key,
    n_samples: int = 1000,
    n_warmup: Optional[int] = None,
    init_params: Optional[dict] = None,
    thin: int = 1,
    n_leapfrog: int = 10,
    chunk_size: int = 100,
    step_size: float = 0.02,
    target_accept: float = 0.9,
    callback=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    row_batch: Optional[int] = None,
    anneal_frac: float = 0.0,
    bias_update: str = "default",
    glm_update: str = "auto",
):
    """Full Bayesian inference (≅ ``gibbs_sample(population, data, N)``).

    Runs ``n_warmup`` adaptation sweeps then ``n_samples·thin`` sampling
    sweeps in device-side chunks of ``chunk_size``; every ``thin``-th params
    pytree streams to host. Returns (samples, diagnostics, final_state) where
    ``samples`` is a dict of numpy arrays with leading axis n_samples.

    Checkpointing (SURVEY.md §5): with ``checkpoint_dir`` set, the full
    sampler state (params + HMC adaptation + PRNG stream + iteration) is
    saved every ``checkpoint_every`` iterations (0 ⇒ once per chunk) and
    already-collected sample chunks are persisted alongside; ``resume=True``
    continues *exactly* where a previous run stopped — unlike the
    reference's rerun-from-a-pickled-sample restart.

    ``bias_update='ars'`` additionally redraws every neuron's bias from its
    exact log-concave conditional by adaptive rejection sampling
    (``inference.ars.update_bias_ars`` — the reference's ARS use case,
    SURVEY.md §2) after each device chunk. Host-side and sequential, so
    never the hot path: use ``chunk_size=1`` to interleave it with every
    sweep (e.g. for stationarity cross-checks of the device bias update);
    composition of invariant kernels keeps exactness for any chunk size.
    Requires the exp-Poisson model. Draws are seeded per chunk from the
    iteration index, so checkpoint-resume replays them exactly; while
    annealed warmup is tempering (β < 1) the ARS pass is skipped (it
    targets the untempered conditional).
    """
    import os

    if n_warmup is None:
        n_warmup = max(100, n_samples // 5)
    if init_params is None:
        init_params = pop.sample(key)

    sweep = make_sweep(pop, data, n_leapfrog=n_leapfrog, target_accept=target_accept,
                       row_batch=row_batch, fisher_params=init_params,
                       glm_update=glm_update)
    state = init_mcmc_state(pop, init_params, step_size=step_size)

    if bias_update not in ("default", "ars"):
        raise ValueError(f"unknown bias_update {bias_update!r}")
    use_ars = bias_update == "ars"
    if use_ars:
        from theano_pyglm_tpu.inference.ars import update_bias_ars

    def apply_bias_ars(state, it):
        if not use_ars:
            return state
        # The host RandomState is reseeded PER CHUNK from (key, iteration)
        # rather than kept as one long stream: the iteration index is part
        # of the checkpoint, so exact resume replays identical ARS draws —
        # a single stream would restart from scratch on resume and silently
        # break the "continues exactly" contract above.
        rng = np.random.RandomState(
            int(
                jax.random.randint(
                    jax.random.fold_in(jax.random.fold_in(key, 7), it),
                    (), 0, 2**31 - 1,
                )
            )
        )
        return {**state, "params": update_bias_ars(rng, pop, state["params"], data)}
    total = n_samples * thin
    it_global = 0  # warmup iters count 0..n_warmup, then sampling continues
    host_chunks = []

    k_run = key
    if resume and checkpoint_dir is not None:
        from theano_pyglm_tpu.utils.checkpoints import latest_step, restore_checkpoint

        step = latest_step(checkpoint_dir)
        if step is not None:
            state, k_run, it_global = *restore_checkpoint(checkpoint_dir, step, template=state)[:2], step
            # Only chunks at or before the restored step count: anything
            # later was produced past the last checkpoint and will be
            # regenerated (deterministically, same key stream) by the loop.
            for f in sorted(os.listdir(checkpoint_dir)):
                if f.startswith("samples_") and f.endswith(".npz"):
                    if int(f[len("samples_"):-len(".npz")]) > step:
                        continue
                    with np.load(os.path.join(checkpoint_dir, f)) as z:
                        host_chunks.append({k: z[k] for k in z.files})

    def persist_samples(it_global, samples_chunk):
        """Every sampling chunk is persisted (sample persistence is decoupled
        from checkpoint cadence — otherwise chunks between checkpoints exist
        only in host memory and a resume silently drops them)."""
        if checkpoint_dir is None or samples_chunk is None:
            return
        os.makedirs(checkpoint_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(checkpoint_dir, f"samples_{it_global:09d}.npz"),
            **samples_chunk,
        )

    def maybe_checkpoint(prev_it, it_global):
        if checkpoint_dir is None:
            return
        # Checkpoint when a checkpoint_every boundary was *crossed* this chunk
        # (exact modulo never fires when checkpoint_every ∤ chunk_size), and
        # always at the very end.
        if (
            checkpoint_every
            and (prev_it // checkpoint_every == it_global // checkpoint_every)
            and it_global < n_warmup + total
        ):
            return
        from theano_pyglm_tpu.utils.checkpoints import save_checkpoint

        os.makedirs(checkpoint_dir, exist_ok=True)
        save_checkpoint(checkpoint_dir, it_global, state, k_run)

    # --- warmup (no collection), with Stan-style adaptation windows
    boundaries = warmup_schedule(n_warmup)
    beta_at = anneal_schedule(n_warmup, anneal_frac)
    # one chunk length for the whole phase ⇒ one compiled scan program
    w_chunk = warmup_chunk(n_warmup, boundaries, chunk_size)
    while it_global < n_warmup:
        next_stop = min(
            [n_warmup] + [b for b, _ in boundaries if b > it_global]
        )
        n = min(w_chunk, next_stop - it_global)
        k_run, k = jax.random.split(k_run)
        prev_it = it_global
        betas = (
            None if beta_at is None
            else jnp.asarray([beta_at(it_global + i) for i in range(n)])
        )
        state, _ = _run_chunk(sweep, n, k, state, jnp.asarray(True), 0, betas,
                              data)
        # ARS targets the FULL-strength conditional, so skip it while the
        # annealed warmup is still tempering (beta < 1): snapping biases to
        # their untempered conditional mid-anneal would fight the tempered
        # device sweeps and distort the adaptation windows.
        if betas is None or float(betas[-1]) >= 1.0:
            state = apply_bias_ars(state, it_global + n)
        it_global += n
        for b, action in boundaries:
            if prev_it < b <= it_global:
                state = adapt_boundary(state, action)
        maybe_checkpoint(prev_it, it_global)
        if callback is not None:
            callback("warmup", it_global, state)

    # --- sampling (uniform chunk length ⇒ one compiled scan program)
    s_chunk = sampling_chunk(total, chunk_size, thin)
    while it_global < n_warmup + total:
        n = min(s_chunk, n_warmup + total - it_global)
        k_run, k = jax.random.split(k_run)
        prev_it = it_global
        phase = it_global - n_warmup
        # Thin on device when the chunk aligns with the global thinning grid
        # (the kept draws are then exactly thin_chunk's selection); otherwise
        # fall back to collect-every-sweep + host thinning. Same PRNG stream
        # and identical retained draws either way.
        ce = thin if (thin > 1 and n % thin == 0 and phase % thin == 0) else 1
        state, samples = _run_chunk(sweep, n, k, state, jnp.asarray(False), ce,
                                    None, data)
        state = apply_bias_ars(state, it_global + n)
        samples = jax.tree.map(np.asarray, samples)
        if ce == 1:
            samples = thin_chunk(samples, thin, phase)
        host_chunks.append(samples)
        it_global += n
        persist_samples(it_global, samples)
        maybe_checkpoint(prev_it, it_global)
        if callback is not None:
            callback("sample", it_global, state)

    samples = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *host_chunks)
    diagnostics = {}
    for name, _ in _HMC_BLOCKS:
        if name in state:
            diagnostics[f"accept_rate_{name}"] = float(state[name].accept_rate)
            diagnostics[f"step_size_{name}"] = float(state[name].step_size)
    return samples, diagnostics, state
