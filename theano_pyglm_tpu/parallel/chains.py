"""Multi-chain MCMC across devices (≅ reference's parallel Gibbs, SURVEY.md
§2 "Parallel Gibbs" / "Multi-chain MCMC").

Chains are a pure batch axis: the single-chain sweep from
:mod:`theano_pyglm_tpu.inference.mcmc` is ``vmap``-ed over chains, the chain
axis is sharded over a 1-D device mesh, and XLA runs each chain's updates on
its own device with zero collectives (chains are independent — the only
cross-device traffic is the final host gather). Acceptance configs 3 and 5
("4 parallel chains", "multi-chain across chips") run through this path.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from theano_pyglm_tpu.inference.mcmc import (
    _GLM_KEYS,
    adapt_boundary,
    init_mcmc_state,
    make_sweep,
    sampling_chunk,
    thin_chunk,
    warmup_chunk,
    warmup_schedule,
)
from theano_pyglm_tpu.utils.diagnostics import summarize_chains

__all__ = ["gibbs_sample_chains"]


def _share_adaptation(states):
    """Consensus adaptation at the warmup→sampling boundary: every chain
    samples with the ACROSS-CHAIN MEDIAN step size and diagonal mass.

    Chains are exchangeable runs of the same kernel, so sharing a fixed
    (post-warmup) step size/mass is valid MCMC — and it removes the
    adaptation-luck failure mode where one chain's dual averaging ends at a
    step size the post-warmup region rejects outright and that chain
    freezes for the whole sampling phase (observed on the round-2 flagship:
    frozen glm blocks with per-chain ε, R̂ in the hundreds)."""
    out = dict(states)
    for name in out:
        h = out[name]
        if not hasattr(h, "step_size"):
            continue
        # during sampling hmc_adaptive_step derives ε from log_eps_avg each
        # step (the frozen dual-averaging iterate), so THAT is what must be
        # shared; step_size is set too for consistency of diagnostics
        med_log_eps = jnp.median(h.log_eps_avg)
        out[name] = h._replace(
            step_size=jnp.full_like(h.step_size, jnp.exp(med_log_eps)),
            log_eps_avg=jnp.full_like(h.log_eps_avg, med_log_eps),
            scale=jax.tree.map(
                lambda s: jnp.broadcast_to(
                    jnp.median(s, axis=0, keepdims=True), s.shape
                ),
                h.scale,
            ),
        )
    return out


def _to_host(x):
    """Device → host numpy, multi-host aware: a globally-sharded array
    (chains spread over processes, parallel/distributed.py) is all-gathered
    so every host sees the full sample stack; locally-addressable arrays are
    a plain copy."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


@partial(jax.jit, static_argnums=(0, 1, 5))
def _run_chunk_chains(vsweep, n_iters, key, states, adapt, collect_every,
                      betas=None, data=None):
    """``collect_every=0``: no collection; ``k >= 1``: collect the chain-
    batched params after sweeps k-1, 2k-1, … (k must divide n_iters for
    k > 1). k > 1 thins ON DEVICE (nested scan) so the per-chunk host
    transfer is 1/k of the raw chains. The PRNG stream is one key per sweep in iteration order, so
    the retained draws are bit-identical for every ``collect_every``.

    ``data`` is passed traced (not closure-captured) so the design tensors
    are program *arguments* rather than HLO literals — see the note inside
    ``make_sweep``: an inlined design makes the program O(T·N·B) bytes."""
    n_chains = states["glm"].t.shape[0]
    if betas is None:
        betas = jnp.ones((n_iters,))

    def body(carry, inp):
        k, beta = inp
        states = vsweep(jax.random.split(k, n_chains), carry, adapt, beta, data)
        return states, (states["params"] if collect_every == 1 else None)

    keys = jax.random.split(key, n_iters)  # (n, 2)
    if collect_every <= 1:
        states, samples = jax.lax.scan(body, states, (keys, betas))
        return states, (samples if collect_every == 1 else None)
    if n_iters % collect_every:
        raise ValueError(
            f"collect_every={collect_every} must divide n_iters={n_iters}"
        )

    def outer(carry, inp):
        keys_b, betas_b = inp
        carry, _ = jax.lax.scan(body, carry, (keys_b, betas_b))
        return carry, carry["params"]

    n_out = n_iters // collect_every
    states, samples = jax.lax.scan(
        outer,
        states,
        (
            keys.reshape((n_out, collect_every) + keys.shape[1:]),
            betas.reshape(n_out, collect_every),
        ),
    )
    return states, samples


def gibbs_sample_chains(
    pop,
    data,
    key,
    n_chains: int = 4,
    n_samples: int = 1000,
    n_warmup: Optional[int] = None,
    init_params=None,
    thin: int = 1,
    n_leapfrog: int = 10,
    chunk_size: int = 100,
    step_size: float = 0.02,
    target_accept: float = 0.9,
    mesh: Optional[Mesh] = None,
    callback=None,
    init_jitter: float = 0.0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    row_batch: Optional[int] = None,
    anneal_frac: float = 0.0,
    glm_update: str = "auto",
):
    """Run ``n_chains`` independent Gibbs/HMC chains, sharded over ``mesh``.

    Returns (samples, diagnostics, states): samples is a dict of numpy arrays
    shaped (n_samples, n_chains, ...); diagnostics includes per-leaf split-R̂
    and ESS (utils.diagnostics) plus per-chain accept rates.

    Checkpointing mirrors :func:`inference.mcmc.gibbs_sample`: with
    ``checkpoint_dir`` set, the full chain-batched sampler state (params +
    HMC adaptation per chain + PRNG + global iteration) is saved whenever a
    ``checkpoint_every`` boundary is crossed (0 ⇒ every chunk), every
    sampling chunk's thinned draws are persisted, and ``resume=True``
    continues exactly where the previous run stopped.
    """
    import os

    if n_warmup is None:
        n_warmup = max(100, n_samples // 5)

    sweep = make_sweep(pop, data, n_leapfrog=n_leapfrog, target_accept=target_accept,
                       row_batch=row_batch, fisher_params=init_params,
                       glm_update=glm_update)

    def vsweep(keys, states, adapt, beta, data=None):
        if mesh is not None:
            # per-chain keys must ride the same sharding as the chain state
            keys = jax.lax.with_sharding_constraint(
                keys, NamedSharding(mesh, P("chains"))
            )
        if data is None:  # compat: fall back to the make_sweep closure
            return jax.vmap(sweep, in_axes=(0, 0, None, None))(
                keys, states, adapt, beta
            )
        return jax.vmap(sweep, in_axes=(0, 0, None, None, None))(
            keys, states, adapt, beta, data
        )

    chain_keys = jax.random.split(key, n_chains + 2)
    if init_params is None:
        init_stack = jax.vmap(pop.sample)(chain_keys[:n_chains])
    else:
        # broadcast one init (e.g. a MAP fit) to all chains, with optional
        # per-chain jitter on the smooth leaves — starting chains near the
        # typical set makes warmup adaptation far more reliable than prior
        # draws (a bad transient poisons the variance window).
        init_stack = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape), init_params
        )
        if init_jitter > 0:
            jit_keys = jax.random.split(chain_keys[0], len(_GLM_KEYS) + 2)
            for k_name, kk in zip(list(_GLM_KEYS) + ["locs", "W"], jit_keys):
                if k_name in init_stack:
                    x = init_stack[k_name]
                    init_stack[k_name] = x + init_jitter * jax.random.normal(
                        kk, x.shape, x.dtype
                    )
    states = jax.vmap(lambda p: init_mcmc_state(pop, p, step_size=step_size))(init_stack)

    if mesh is not None:
        chain_sh = NamedSharding(mesh, P("chains"))
        states = jax.tree.map(lambda x: jax.device_put(x, chain_sh), states)
        data = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, P())), data)

    k_warm, k_samp = jax.random.split(chain_keys[-1])
    total_sampling = n_samples * thin
    it_global = 0  # warmup iters count 0..n_warmup, then sampling continues
    host_chunks = []

    if resume and checkpoint_dir is not None:
        from theano_pyglm_tpu.utils.checkpoints import latest_step, restore_checkpoint

        step = latest_step(checkpoint_dir)
        if step is not None:
            restored, k_restored, _ = restore_checkpoint(checkpoint_dir, step, template=states)
            states, it_global = restored, step
            if it_global < n_warmup:
                k_warm = k_restored
            elif it_global > n_warmup:
                k_samp = k_restored
            # it_global == n_warmup: the checkpoint was written at the
            # warmup/sampling boundary, so k_restored belongs to the WARMUP
            # key stream. The fresh-run sampling phase derives k_samp from
            # chain_keys[-1] (same top-level key ⇒ same value here), so
            # keeping it reproduces the uninterrupted run exactly; assigning
            # k_restored would silently switch the sampling PRNG stream.
            if mesh is not None:
                chain_sh = NamedSharding(mesh, P("chains"))
                states = jax.tree.map(lambda x: jax.device_put(x, chain_sh), states)
            for f in sorted(os.listdir(checkpoint_dir)):
                if f.startswith("samples_") and f.endswith(".npz"):
                    if int(f[len("samples_"):-len(".npz")]) > step:
                        continue
                    with np.load(os.path.join(checkpoint_dir, f)) as z:
                        host_chunks.append({k: z[k] for k in z.files})

    def persist_samples(it_g, samples_chunk):
        if checkpoint_dir is None or samples_chunk is None:
            return
        if jax.process_index() != 0:
            return
        os.makedirs(checkpoint_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(checkpoint_dir, f"samples_{it_g:09d}.npz"), **samples_chunk
        )

    def maybe_checkpoint(prev_it, it_g, k_base):
        if checkpoint_dir is None:
            return
        if (
            checkpoint_every
            and (prev_it // checkpoint_every == it_g // checkpoint_every)
            and it_g < n_warmup + total_sampling
        ):
            return
        from theano_pyglm_tpu.utils.checkpoints import save_checkpoint

        # all-gather is collective — every process participates, rank 0 writes
        host_states = jax.tree.map(_to_host, states)
        if jax.process_index() != 0:
            return
        os.makedirs(checkpoint_dir, exist_ok=True)
        save_checkpoint(checkpoint_dir, it_g, host_states, k_base)

    from theano_pyglm_tpu.inference.mcmc import anneal_schedule

    beta_at = anneal_schedule(n_warmup, anneal_frac)

    def run_phase(k_base, phase_start, total, adapt, collect, boundaries=()):
        nonlocal states, it_global
        it = it_global - phase_start
        # one chunk length per phase ⇒ one compiled scan program: divisor-
        # aligned to the adaptation boundaries (warmup) or to total+thin
        # (sampling — keeps the device-thinning path on every chunk)
        eff_chunk = (
            warmup_chunk(total, boundaries, chunk_size)
            if boundaries
            else sampling_chunk(total, chunk_size, thin if collect else 1)
        )
        while it < total:
            next_stop = min([total] + [b for b, _ in boundaries if b > it])
            n = min(eff_chunk, next_stop - it)
            k_base, k = jax.random.split(k_base)
            prev_it = it
            betas = (
                None if (collect or beta_at is None)
                else jnp.asarray([beta_at(prev_it + i) for i in range(n)])
            )
            # Device-side thinning when the chunk aligns with the global
            # thinning grid; otherwise collect every sweep + host thinning.
            # Identical PRNG stream and retained draws either way.
            ce = 0
            if collect:
                ce = thin if (thin > 1 and n % thin == 0 and prev_it % thin == 0) else 1
            states, samples = _run_chunk_chains(
                vsweep, n, k, states, adapt, ce, betas, data
            )
            for b, action in boundaries:
                if prev_it < b <= prev_it + n:
                    states = adapt_boundary(states, action)
            if collect:
                samples = jax.tree.map(_to_host, samples)
                if ce == 1:
                    samples = thin_chunk(samples, thin, prev_it)
                host_chunks.append(samples)
            it += n
            it_global = phase_start + it
            if collect:
                persist_samples(it_global, samples)
            maybe_checkpoint(phase_start + prev_it, it_global, k_base)
            if callback is not None:
                callback("sample" if collect else "warmup", it, states)

    if it_global < n_warmup:
        run_phase(k_warm, 0, n_warmup, jnp.asarray(True), False, warmup_schedule(n_warmup))
    if it_global == n_warmup:
        # idempotent, and also covers a resume from a checkpoint that
        # landed exactly on the warmup/sampling boundary (pre-sharing)
        states = _share_adaptation(states)
    run_phase(k_samp, n_warmup, total_sampling, jnp.asarray(False), True)

    samples = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *host_chunks)
    diagnostics = {"convergence": summarize_chains(samples)}
    for name in ("glm", "imp", "latent"):
        if name in states:
            diagnostics[f"accept_rate_{name}"] = _to_host(states[name].accept_rate)
            diagnostics[f"step_size_{name}"] = _to_host(states[name].step_size)
    return samples, diagnostics, states
