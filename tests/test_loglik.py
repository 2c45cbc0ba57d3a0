"""Log-joint oracle tests vs an independent pure-numpy implementation.

This is the BASELINE.md acceptance bar: the jitted log-joint must match a
slow numpy reference to 1e-6 (run in float64, SURVEY.md §4/§7).
"""

import jax
import numpy as np
import pytest

from theano_pyglm_tpu import Population, make_model
from theano_pyglm_tpu.inference.map import split_params
from theano_pyglm_tpu.utils.oracle import central_difference_grad, numpy_log_joint


def _setup(name, N, T=400, seed=0):
    spec = make_model(name, N)
    pop = Population(spec)
    params = pop.sample(jax.random.PRNGKey(seed))
    D = spec["bkgd"].get("D_stim", 1)
    r = np.random.RandomState(seed)
    stim = r.randn(T, D)
    # Arbitrary spikes suffice for density agreement — no need to simulate.
    S = r.poisson(0.05, size=(T, N)).astype(float)
    data = pop.prepare_data(S, stim=stim)
    return pop, params, data


def test_oracle_agreement_all_models():
    for name, N in [
        ("standard_glm", 2),
        ("spatiotemporal_glm", 2),
        ("simple_weighted_model", 3),
        ("sparse_weighted_model", 3),
        ("sbm_weighted_model", 4),
        ("distance_weighted_model", 3),
    ]:
        pop, params, data = _setup(name, N)
        got = float(pop.log_joint(params, data))
        want = numpy_log_joint(pop, params, data)
        # 1e-6 *relative* agreement (float64 verification mode)
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (name, got, want)


def test_oracle_agreement_saturated_regime():
    """The clipped-exp spec in the regime that caused the round-2 flagship
    NaN: |I| > 40 on many bins (here forced via an absurd bias). The jitted
    log-joint must (a) agree with the clipping numpy oracle to 1e-6 and
    (b) stay finite — with the unclipped oracle the two would disagree by
    construction, which is exactly what this test exists to catch."""
    pop, params, data = _setup("sparse_weighted_model", 3)
    for bias_val in (55.0, -55.0):
        p = dict(params)
        p["bias"] = jax.numpy.full_like(params["bias"], bias_val)
        got = float(pop.log_joint(p, data))
        want = numpy_log_joint(pop, p, data)
        assert np.isfinite(got), got
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (bias_val, got, want)


def test_bernoulli_observation_oracle():
    spec = make_model("standard_glm", 2, observation={"type": "bernoulli"})
    pop = Population(spec)
    params = pop.sample(jax.random.PRNGKey(0))
    T = 300
    r = np.random.RandomState(0)
    stim = r.randn(T, 1)
    S = (r.rand(T, 2) < 0.05).astype(float)
    data = pop.prepare_data(S, stim=stim)
    got = float(pop.log_joint(params, data))
    want = numpy_log_joint(pop, params, data)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_likelihood_factorizes_over_neurons():
    pop, params, data = _setup("sparse_weighted_model", 3)
    per = np.asarray(pop.log_likelihood_per_neuron(params, data))
    tot = float(pop.log_likelihood(params, data))
    np.testing.assert_allclose(per.sum(), tot, rtol=1e-12)


def test_grad_matches_finite_differences():
    pop, params, data = _setup("sparse_weighted_model", 3, T=200)
    opt, frozen = split_params(params)

    def f(o):
        return pop.log_joint({**frozen, **o}, data)

    g = jax.grad(f)(opt)
    rng = np.random.RandomState(3)
    for k in ["bias", "W", "w_ir"]:
        v = np.asarray(opt[k])
        direction = rng.randn(*v.shape)
        eps = 1e-6
        plus = {**opt, k: opt[k] + eps * direction}
        minus = {**opt, k: opt[k] - eps * direction}
        fd = (float(f(plus)) - float(f(minus))) / (2 * eps)
        an = float(np.sum(np.asarray(g[k]) * direction))
        np.testing.assert_allclose(an, fd, rtol=1e-4, atol=1e-4)


def test_time_chunked_ll_matches_unchunked():
    """time_chunk streams the LL over blocks (SURVEY §5 long-context):
    value and gradient must match the monolithic path exactly, including
    when the chunk size does not divide T."""
    import jax.numpy as jnp

    spec = make_model("sparse_weighted_model", 3)
    pop = Population(spec)
    pop_c = Population(spec, time_chunk=128)  # 700 % 128 != 0
    rng = np.random.RandomState(0)
    stim = rng.randn(700, 1)
    true = pop.sample(jax.random.PRNGKey(0))
    S, _ = pop.simulate(jax.random.PRNGKey(1), true, 700, stim=stim)
    data = pop.prepare_data(S, stim=stim)

    ll = float(pop.log_likelihood(true, data))
    ll_c = float(pop_c.log_likelihood(true, data))
    np.testing.assert_allclose(ll_c, ll, rtol=1e-12)

    opt, frozen = split_params(true)
    g = jax.grad(lambda o: pop.log_joint({**frozen, **o}, data))(opt)
    g_c = jax.grad(lambda o: pop_c.log_joint({**frozen, **o}, data))(opt)
    for k in g:
        np.testing.assert_allclose(np.asarray(g_c[k]), np.asarray(g[k]), rtol=1e-9)


def test_streaming_design_matches_materialized():
    """materialize_design=False rebuilds each block's X_imp from the spikes
    with a causal halo — identical LL/grad to the precomputed design (up to
    the column-centering reparameterization, which streaming mode skips:
    centering only shifts where the constant current is accounted, so the
    *likelihood at equal params* must still agree)."""
    import jax.numpy as jnp

    spec = make_model("sparse_weighted_model", 3, bkgd={"type": "none"})
    pop_ref = Population(spec)
    pop_str = Population(spec, time_chunk=200)
    true = pop_ref.sample(jax.random.PRNGKey(0))
    S, _ = pop_ref.simulate(jax.random.PRNGKey(1), true, 900)

    data_ref = pop_ref.prepare_data(S)
    data_str = pop_str.prepare_data(S, materialize_design=False)
    assert "X_imp" not in data_str

    ll_ref = float(pop_ref.log_likelihood(true, data_ref))
    ll_str = float(pop_str.log_likelihood(true, data_str))
    np.testing.assert_allclose(ll_str, ll_ref, rtol=1e-10)

    opt, frozen = split_params(true)
    g_ref = jax.grad(lambda o: pop_ref.log_joint({**frozen, **o}, data_ref))(opt)
    g_str = jax.grad(lambda o: pop_str.log_joint({**frozen, **o}, data_str))(opt)
    for k in g_ref:
        np.testing.assert_allclose(
            np.asarray(g_str[k]), np.asarray(g_ref[k]), rtol=1e-8, atol=1e-10
        )


def test_streaming_without_time_chunk_raises():
    spec = make_model("sparse_weighted_model", 2, bkgd={"type": "none"})
    pop = Population(spec)
    true = pop.sample(jax.random.PRNGKey(0))
    S, _ = pop.simulate(jax.random.PRNGKey(1), true, 300)
    data = pop.prepare_data(S, materialize_design=False)

    with pytest.raises(ValueError, match="materialize_design"):
        pop.log_likelihood(true, data)


ZOO = [
    ("standard_glm", 2),
    ("spatiotemporal_glm", 2),
    ("simple_weighted_model", 3),
    ("sparse_weighted_model", 3),
    ("sbm_weighted_model", 4),
    ("distance_weighted_model", 3),
]


@pytest.fixture
def f32_mode():
    """The production dtype: float32, x64 off (restored afterwards)."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("name,N", ZOO)
def test_float32_value_and_grad_match_float64_oracle(f32_mode, name, N):
    """The float32 program against the float64 numpy oracle: value to 1e-5
    relative, gradient (central differences of the oracle) to 1e-4 rel-L2 —
    the bar chip_smoke.py holds the card to at full width."""
    pop, params, data = _setup(name, N, T=1000)
    opt, frozen = split_params(params)
    val, grad = jax.jit(jax.value_and_grad(
        lambda o: pop.log_joint({**frozen, **o}, data)))(opt)
    host_params = {k: np.asarray(v) for k, v in params.items()}
    host_data = {k: np.asarray(v) for k, v in data.items()}
    assert np.asarray(data["S"]).dtype == np.float32

    want = numpy_log_joint(pop, host_params, host_data)
    assert abs(float(val) - want) <= 1e-5 * max(1.0, abs(want)), (float(val), want)

    coords = [(k, i) for k in sorted(opt) for i in range(min(3, np.size(opt[k])))]
    fd = central_difference_grad(pop, host_params, host_data, coords)
    got = np.array([np.ravel(np.asarray(grad[k]))[i] for k, i in coords], np.float64)
    assert np.linalg.norm(got - fd) <= 1e-4 * np.linalg.norm(fd), (got, fd)
