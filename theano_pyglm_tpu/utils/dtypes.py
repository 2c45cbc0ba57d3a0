"""Precision policy.

Production runs float32 (optionally with bf16 design tensors);
verification mode (SURVEY.md §7 "Numerics", the 1e-6 agreement bar) runs the
same code under ``jax.config.update('jax_enable_x64', True)`` on CPU. Code
therefore never hardcodes float32 for model-facing arrays — it asks
:func:`default_float`, which follows the x64 flag.
"""

import jax
import jax.numpy as jnp

__all__ = ["default_float", "full_precision_matmuls"]


def default_float():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def full_precision_matmuls():
    """Context under which the log-joint and the Gibbs sweep are traced.

    On the GPU a float32 matmul at the default precision runs as TF32
    (10-bit mantissa). At the flagship shape (N=27, T=60k) that left the
    log-joint gradient ~1e-3 (rel-L2) from the float64 oracle, against a
    1e-4 bar, and the same rounding enters every MH ratio the sweep sums
    over T. Every matmul traced inside this context runs in full float32
    instead (PERF.md; ROADMAP S4 weighs the cost per op). No effect on the
    CPU."""
    return jax.default_matmul_precision("highest")
