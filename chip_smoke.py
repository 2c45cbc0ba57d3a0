#!/usr/bin/env python
"""Bring-up check: the flagship network GLM end to end on one GPU.

Drives the main path once through the public API, the way
``scripts/rgc_flagship.py`` does, at acceptance config 5's full width:
``distance_weighted_model`` with N=27 neurons, T=60,000 bins of 1 ms and a
stimulus drive, simulated from random parameters drawn from ``--seed``.

  1. device     require a GPU (no CPU fallback); print its kind, the device
                count and the card's name and power limit from nvidia-smi
  2. cache      persistent compilation cache (utils/compile_cache.py)
  3. oracle     float32 log-joint value+grad on the card against the float64
                numpy oracle (utils/oracle.py), at the program's own matmul
                precision and under default_matmul_precision("highest")
  4. map        map_fit(smart_initialize(...)): the fitted log-joint is finite
                and at least the log-joint at the generating parameters
  5. mcmc       gibbs_sample_chains, 4 chains on one card: finite draws,
                acceptance rates in (0, 1]; compile time and steady ms per
                4-chain sweep reported apart
  6. streaming  time-chunked likelihood with the spike design rebuilt per
                block (materialize_design=False) equals the materialized one

Any failed check exits non-zero. The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed. Everything runs in this one process:
a JAX process reserves most of the card's memory when it starts.

  python chip_smoke.py [--seed 0]
  python chip_smoke.py --four   # four GPUs: the sharded paths only
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import jax
import numpy as np

from theano_pyglm_tpu import Population, make_model
from theano_pyglm_tpu.inference import map_fit
from theano_pyglm_tpu.inference.map import split_params
from theano_pyglm_tpu.inference.smart_init import smart_initialize
from theano_pyglm_tpu.parallel import (
    chain_mesh,
    gibbs_sample_chains,
    make_sharded_value_and_grad,
)
from theano_pyglm_tpu.parallel.mesh import neuron_mesh
from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache
from theano_pyglm_tpu.utils.device import describe_gpu
from theano_pyglm_tpu.utils.oracle import central_difference_grad, numpy_log_joint

# A float32 reduction over T·N = 1.6 M bins against a float64 oracle: the
# value keeps ~7 digits of a ~1e5 sum, and the gradient's sums cancel
# (S − λ·dt has mean ≈ 0 near the generating parameters), so its bar is
# looser. The float64 CPU tests hold the same code to 1e-6.
LOGJOINT_RTOL = 1e-5
GRAD_RTOL = 1e-4
# Chain-sharded draws against the same key on one card, after one sweep: the
# per-chain programs match up to reduction order, so continuous draws agree
# to float32 round-off and discrete draws exactly.
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-5

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(1e-12, np.linalg.norm(want)))


def flat(tree) -> np.ndarray:
    return np.concatenate(
        [np.ravel(np.asarray(tree[k], np.float64)) for k in sorted(tree)]
    )


class CompileClock:
    """Wall time spent tracing, lowering and compiling, from JAX's own
    monitoring spans. Nested spans (a jit traced inside another) are merged,
    so the total is the union of the intervals in a window."""

    def __init__(self):
        self.spans = []
        jax.monitoring.register_event_time_span_listener(self._on_span)

    def close(self):
        jax.monitoring.unregister_event_time_span_listener(self._on_span)

    def _on_span(self, event, start, end, **_):
        if event in _COMPILE_EVENTS:
            self.spans.append((start, end))

    def seconds(self, t0: float, t1: float) -> float:
        total, cur_s, cur_e = 0.0, None, None
        for s, e in sorted((max(s, t0), min(e, t1)) for s, e in self.spans):
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def build_flagship(seed: int, N: int = 27, T: int = 60_000, card: str = ""):
    """Acceptance config 5's model and data, as scripts/rgc_flagship.py
    builds them. Returns (spec, pop, true, stim, S, data, mcmc_key)."""
    spec = make_model("distance_weighted_model", N)
    spec["bias"] = {"mu": 3.0, "sigma": 0.4}  # RGC-like ~20 Hz baseline
    pop = Population(spec)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    true = pop.sample(k1)
    stim = np.asarray(jax.random.normal(k2, (T, 1)), np.float32)
    t0 = time.perf_counter()
    S, rates = pop.simulate(k3, true, T, stim=stim)
    data = pop.prepare_data(S, stim=stim)
    jax.block_until_ready(data)
    S_host = np.asarray(S)
    log(f"simulate+prepare_data: N={N} T={T} spikes={S_host.sum():.0f} "
        f"mean rate {float(np.asarray(rates).mean()):.3f} Hz, "
        f"{time.perf_counter() - t0:.3f} s (compile included) [{card}]")
    check(np.all(np.isfinite(S_host)), "simulated spikes not finite")
    return spec, pop, true, stim, S, data, k4


def _grad_coords(opt, A, n_per_leaf: int, seed: int):
    """``n_per_leaf`` flat coordinates of every continuous leaf; for W only
    present edges, whose gradient carries the likelihood."""
    rng = np.random.RandomState(seed)
    coords = []
    for k in sorted(opt):
        cand = np.arange(np.size(opt[k]))
        if k == "W" and np.any(A > 0):
            cand = np.flatnonzero(np.ravel(A) > 0)
        for idx in rng.choice(cand, size=min(n_per_leaf, cand.size), replace=False):
            coords.append((k, int(idx)))
    return coords


def phase_oracle(pop, params, data, card: str, n_per_leaf: int = 3, seed: int = 0):
    """Float32 value+grad on the device against the float64 numpy oracle.

    Returns the program-precision (value, grad) for the streaming phase."""
    opt, frozen = split_params(params)
    coords = _grad_coords(opt, np.asarray(params["A"]), n_per_leaf, seed)
    host_params = {k: np.asarray(v) for k, v in params.items()}
    host_data = {k: np.asarray(v) for k, v in data.items()}
    t0 = time.perf_counter()
    want_val = numpy_log_joint(pop, host_params, host_data)
    want_grad = central_difference_grad(pop, host_params, host_data, coords)
    log(f"oracle: float64 numpy log-joint {want_val:.6f} and central "
        f"differences on {len(coords)} coordinates in "
        f"{time.perf_counter() - t0:.3f} s (host)")

    out = {}
    for label, ctx in (("program", contextlib.nullcontext()),
                       ("highest", jax.default_matmul_precision("highest"))):
        with ctx:
            vg = jax.jit(jax.value_and_grad(
                lambda o: pop.log_joint({**frozen, **o}, data)))
            t0 = time.perf_counter()
            val, grad = jax.block_until_ready(vg(opt))
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            jax.block_until_ready(vg(opt))
            warm = time.perf_counter() - t0
        got = np.array([np.ravel(np.asarray(grad[k]))[i] for k, i in coords])
        r_val = abs(float(val) - want_val) / max(1.0, abs(want_val))
        r_grad = rel_l2(got, want_grad)
        out[label] = (float(val), {k: np.asarray(v) for k, v in grad.items()},
                      r_val, r_grad)
        log(f"oracle [{label} precision]: log-joint {float(val):.6f} "
            f"rel err {r_val:.3e} (bar {LOGJOINT_RTOL:g}), grad rel-L2 "
            f"{r_grad:.3e} (bar {GRAD_RTOL:g}); value+grad {cold:.3f} s "
            f"cold, {warm * 1e3:.3f} ms warm [{card}]")
    log("oracle: program vs highest precision, full gradient rel-L2 "
        f"{rel_l2(flat(out['program'][1]), flat(out['highest'][1])):.3e}")
    val, grad, r_val, r_grad = out["program"]
    check(r_val <= LOGJOINT_RTOL, f"log-joint rel err {r_val:.3e}")
    check(r_grad <= GRAD_RTOL, f"grad rel-L2 {r_grad:.3e}")
    return val, grad


def phase_map(pop, data, true, card: str):
    """MAP from the smart init; healthy when it reaches the generating
    parameters' log-joint."""
    lp_true = float(jax.jit(pop.log_joint)(true, data))
    t0 = time.perf_counter()
    fit, lp, iters = map_fit(pop, data, smart_initialize(pop, data))
    lp, iters = float(lp), int(iters)
    log(f"map: log-joint {lp:.6f} after {iters} L-BFGS iterations vs "
        f"{lp_true:.6f} at the generating parameters; "
        f"{time.perf_counter() - t0:.3f} s (compile included) [{card}]")
    check(np.isfinite(lp), "MAP log-joint not finite")
    check(lp >= lp_true, "MAP log-joint below the generating parameters'")
    return fit


def _sample_chains(pop, data, init, key, n_chains, n_warmup, n_samples, mesh,
                   clock: CompileClock):
    """One gibbs_sample_chains call; returns (samples, diag, wall, compile)."""
    # each chunk's states are waited for, so the window ends with the work
    done = lambda phase, it, states: jax.block_until_ready(states)  # noqa: E731
    t0 = time.time()
    samples, diag, _ = gibbs_sample_chains(
        pop, data, key, n_chains=n_chains, n_samples=n_samples,
        n_warmup=n_warmup, thin=1, chunk_size=max(n_warmup, n_samples),
        mesh=mesh, init_params=init, init_jitter=0.05, callback=done,
    )
    t1 = time.time()
    return samples, diag, t1 - t0, clock.seconds(t0, t1)


def _check_draws(samples, diag, n_samples, n_chains, tag):
    for k, v in samples.items():
        check(v.shape[:2] == (n_samples, n_chains), f"draws of {k}: shape {v.shape}")
        if np.issubdtype(v.dtype, np.floating):
            check(np.all(np.isfinite(v)), f"non-finite draws of {k}")
    for k, v in sorted(diag.items()):
        if k.startswith("accept_rate"):
            v = np.asarray(v)
            log(f"{tag}: {k} per chain {np.array2string(v, precision=3)}")
            check(np.all((v > 0) & (v <= 1)), f"{k} outside (0, 1]: {v}")


def phase_mcmc(pop, data, init, key, card: str, clock: CompileClock,
               n_chains: int = 4, n_warmup: int = 20, n_samples: int = 20):
    samples, diag, wall, comp = _sample_chains(
        pop, data, init, key, n_chains, n_warmup, n_samples, None, clock)
    n_sweeps = n_warmup + n_samples
    log(f"mcmc: {n_chains} chains x ({n_warmup} warmup + {n_samples} samples) "
        f"on one card: compile {comp:.3f} s, steady "
        f"{(wall - comp) / n_sweeps * 1e3:.3f} ms per {n_chains}-chain sweep "
        f"(wall {wall:.3f} s less compile, over {n_sweeps} sweeps) [{card}]")
    _check_draws(samples, diag, n_samples, n_chains, "mcmc")
    return samples


def phase_streaming(spec, params, S, stim, ref, card: str, time_chunk: int = 8192):
    """Value+grad with the design rebuilt per time block vs materialized."""
    pop_s = Population(spec, time_chunk=time_chunk)
    data_s = pop_s.prepare_data(S, stim=stim, materialize_design=False)
    check("X_imp" not in data_s, "streaming data kept a materialized design")
    opt, frozen = split_params(params)
    vg = jax.jit(jax.value_and_grad(
        lambda o: pop_s.log_joint({**frozen, **o}, data_s)))
    t0 = time.perf_counter()
    val, grad = jax.block_until_ready(vg(opt))
    cold = time.perf_counter() - t0
    ref_val, ref_grad = ref
    r_val = abs(float(val) - ref_val) / max(1.0, abs(ref_val))
    r_grad = rel_l2(flat(grad), flat(ref_grad))
    log(f"streaming (time_chunk={time_chunk}): log-joint rel diff {r_val:.3e}, "
        f"grad rel-L2 {r_grad:.3e} vs materialized; value+grad {cold:.3f} s "
        f"cold [{card}]")
    check(r_val <= LOGJOINT_RTOL, f"streaming log-joint rel diff {r_val:.3e}")
    check(r_grad <= GRAD_RTOL, f"streaming grad rel-L2 {r_grad:.3e}")


def _draws_agree(a, b) -> bool:
    """Continuous draws to CHAIN_RTOL/ATOL, discrete ones (A) exactly."""
    return all(
        np.allclose(b[k], a[k], rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
        if np.issubdtype(a[k].dtype, np.floating) and k != "A"
        else np.array_equal(a[k], b[k])
        for k in a
    )


def four_chains(pop, data, init, key, card: str, clock: CompileClock,
                n_devices: int = 4, n_warmup: int = 20, n_samples: int = 20):
    """Chains sharded one per device against the same key on one device.

    The sharded program sums in another order than the batched one, and
    MCMC is chaotic under that: once one accept decision falls the other
    way, the two trajectories part for good. So the draws are held to
    CHAIN_RTOL after one sweep; phase 5's configuration is then timed on
    both, and how far its draws agree is reported."""
    meshes = (("one device", None),
              (f"chain_mesh({n_devices})", chain_mesh(n_devices)))
    first, runs = {}, {}
    for label, mesh in meshes:
        first[label] = _sample_chains(
            pop, data, init, key, n_devices, 0, 1, mesh, clock)[0]
    one, sharded = first.values()
    for k in sorted(one):
        diff = float(np.max(np.abs(np.asarray(one[k], np.float64) - sharded[k])))
        log(f"four/chains: first sweep, {k} max |sharded - one device| {diff:.3e}")
    check(_draws_agree(one, sharded),
          "sharded first-sweep draws differ from one device")

    for label, mesh in meshes:
        samples, diag, wall, comp = _sample_chains(
            pop, data, init, key, n_devices, n_warmup, n_samples, mesh, clock)
        runs[label] = samples
        log(f"four/chains [{label}]: {n_devices} chains x ({n_warmup} + "
            f"{n_samples}) sweeps, compile {comp:.3f} s, steady "
            f"{(wall - comp) / (n_warmup + n_samples) * 1e3:.3f} ms per sweep "
            f"[{card}]")
        _check_draws(samples, diag, n_samples, n_devices, f"four/chains [{label}]")
    one, sharded = runs.values()
    n_same = next((i for i in range(n_samples) if not _draws_agree(
        {k: v[i] for k, v in one.items()},
        {k: v[i] for k, v in sharded.items()})), n_samples)
    log(f"four/chains: phase-5 draws agree to rtol {CHAIN_RTOL:g} for the "
        f"first {n_same} of {n_samples} retained draws")


def four_neurons(seed: int, card: str, n_devices: int = 4, N: int = 28,
                 T: int = 60_000):
    """Neuron-sharded value+grad of −log_joint against one device. N must
    divide by the mesh size (parallel/neurons.py)."""
    spec, pop, params, _, _, data, _ = build_flagship(seed, N=N, T=T, card=card)
    single = jax.jit(jax.value_and_grad(lambda p, d: -pop.log_joint(p, d)))
    sharded = make_sharded_value_and_grad(pop, neuron_mesh(n_devices), params, data)
    res = {}
    for label, fn in (("one device", single),
                      (f"neuron_mesh({n_devices})", sharded)):
        t0 = time.perf_counter()
        val, grad = jax.block_until_ready(fn(params, data))
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(fn(params, data))
        warm = time.perf_counter() - t0
        res[label] = (float(val), grad)
        log(f"four/neurons [{label}]: N={N} T={T} value+grad {cold:.3f} s "
            f"cold, {warm * 1e3:.3f} ms warm [{card}]")
    (v1, g1), (v4, g4) = res.values()
    r_val = abs(v4 - v1) / max(1.0, abs(v1))
    r_grad = rel_l2(flat(g4), flat(g1))
    log(f"four/neurons: value rel diff {r_val:.3e}, grad rel-L2 {r_grad:.3e}")
    check(r_val <= LOGJOINT_RTOL, f"sharded value rel diff {r_val:.3e}")
    check(r_grad <= GRAD_RTOL, f"sharded grad rel-L2 {r_grad:.3e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the chain- and neuron-sharded paths on four "
                         "GPUs, each against one GPU")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four else 1

    card = describe_gpu(n_dev, emit=log)  # the label printed beside times
    log(f"compile cache: {enable_compile_cache()}")
    clock = CompileClock()
    spec, pop, true, stim, S, data, k_mcmc = build_flagship(args.seed, card=card)
    if args.four:
        # the generating parameters seed the chains: MAP is not sharded
        four_chains(pop, data, true, k_mcmc, card, clock, n_devices=n_dev)
        four_neurons(args.seed, card, n_devices=n_dev)
    else:
        ref = phase_oracle(pop, true, data, card)
        fit = phase_map(pop, data, true, card)
        phase_mcmc(pop, data, fit, k_mcmc, card, clock)
        phase_streaming(spec, true, S, stim, ref, card)

    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}), flush=True)


if __name__ == "__main__":
    main()
