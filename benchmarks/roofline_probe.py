#!/usr/bin/env python
"""Roofline probe: copy and reduction bandwidth and matmul rates of the card.

Measures the device it runs on and prints each rate beside the published
peak for that ``device_kind`` (``PEAKS`` below), with the card's name and
power limit from nvidia-smi. A device kind missing from the table prints
that no peak is known; none is assumed. It stops unless JAX's first device
is a GPU.

Two details keep the numbers honest:

1. **Anti-DCE that survives f32.** The per-iteration perturbation
   ``x * (1 + 1e-30 * i)`` constant-folds to identity in f32 (1 + 1e-30
   == 1.0), so XLA deletes the whole scan body and the "measured" rates are
   fiction. The scale must exceed f32 epsilon: ``1 + 1e-6 * i``.
2. **Amortized dispatch.** Each measurement runs REP repetitions inside one
   ``lax.scan``, and the time of a null dispatch+fetch is printed and
   subtracted, so the rate is the device's and not the host's.

  python benchmarks/roofline_probe.py [--rep 200] [--mb 512]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# Published dense peaks (no sparsity) at the card's full power limit, keyed by
# jax.Device.device_kind. Source: NVIDIA H100 data sheet, SXM part.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "memory_GBps": 3350.0,
        "bf16_TFLOPs": 989.0,
        "tf32_TFLOPs": 495.0,
        "f32_TFLOPs": 67.0,
    },
}


def share(rate, kind, key):
    peak = PEAKS.get(kind, {}).get(key)
    if peak is None:
        return f"no published {key} peak known for {kind!r}"
    return f"{100 * rate / peak:.1f}% of the {peak:g} published {key}"


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rep", type=int, default=200)
    p.add_argument("--mb", type=int, default=512)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache
    from theano_pyglm_tpu.utils.device import describe_gpu

    card = describe_gpu()
    enable_compile_cache()
    kind = jax.devices()[0].device_kind
    REP, mb = args.rep, args.mb

    def bench(fn, x):
        np.asarray(fn(x))  # compile
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(fn(x))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    nul = bench(jax.jit(lambda x: x + 1.0), jnp.float32(1.0))
    print(f"null dispatch+fetch: {nul * 1e3:.3f} ms [{card}]")

    n = mb * 1024 * 1024 // 4
    x = jnp.full((n,), 0.5, jnp.float32)

    @jax.jit
    def copyloop(x):
        def body(c, i):
            return c * (1.0 + 1e-6 * i.astype(jnp.float32)), None

        y, _ = jax.lax.scan(body, x, jnp.arange(REP))
        return jnp.sum(y[:8])

    dt = bench(copyloop, x) - nul
    gbps = 2 * mb / 1024 * REP / dt
    print(f"copy {mb}MB x{REP}: {gbps:.0f} GB/s, "
          f"{share(gbps, kind, 'memory_GBps')} [{card}]")

    @jax.jit
    def redloop(x):
        def body(c, i):
            return c + jnp.sum(x * (1.0 + 1e-6 * i.astype(jnp.float32))), None

        s, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(REP))
        return s

    dt = bench(redloop, x) - nul
    gbps = mb / 1024 * REP / dt
    print(f"1d-sum {mb}MB x{REP}: {gbps:.0f} GB/s, "
          f"{share(gbps, kind, 'memory_GBps')} [{card}]")

    m = 4096
    for dtype, name, prec, peak_key in (
        (jnp.bfloat16, "bf16", None, "bf16_TFLOPs"),
        (jnp.float32, "f32 default precision", None, "tf32_TFLOPs"),
        (jnp.float32, "f32 highest precision", "highest", "f32_TFLOPs"),
    ):
        a = (jnp.eye(m, dtype=jnp.float32) * 0.999).astype(dtype)

        @jax.jit
        def mmloop(a):
            def body(c, i):
                return jnp.dot(c, a, preferred_element_type=dtype,
                               precision=prec), None

            y, _ = jax.lax.scan(body, a, jnp.arange(REP))
            return jnp.sum(y[:2, :2].astype(jnp.float32))

        dt = bench(mmloop, a) - nul
        tflops = 2 * m**3 * REP / dt / 1e12
        print(f"matmul {name} {m}^3 x{REP}: {tflops:.1f} TFLOP/s, "
              f"{share(tflops, kind, peak_key)} [{card}]")


if __name__ == "__main__":
    main()
