"""Checkpoint / exact resume as numpy ``.npz`` files (SURVEY.md §5
"Checkpoint / resume").

The reference periodically pickles the MCMC sample list and restarts by
re-running from a loaded state [M]. Here checkpoints capture the complete
sampler state — params pytree, HMC adaptation state, PRNG key, iteration
counter — so a resumed chain continues *exactly* (same randomness stream,
same step sizes).

Layout: ``<directory>/ckpt_<step:09d>.npz`` holds the flattened state pytree
(``leaf_<i>`` in ``jax.tree`` order) and the raw PRNG key data (``key``).
A file is written under a temporary name and renamed into place, so a crash
mid-write never leaves a truncated checkpoint that ``latest_step`` would
pick. Only the newest ``max_to_keep`` files are kept.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import jax
import numpy as np

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_NAME = re.compile(r"^ckpt_(\d+)\.npz$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{int(step):09d}.npz")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _NAME.match(f)))


def save_checkpoint(directory: str, step: int, state: dict, key, max_to_keep: int = 3) -> None:
    """Persist sampler state. ``state`` is the MCMC carry dict
    (params + HMCState blocks); ``key`` the upcoming PRNG key."""
    os.makedirs(directory, exist_ok=True)
    leaves = jax.tree.leaves(state)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["key"] = np.asarray(jax.random.key_data(key))
    final = _path(directory, step)
    tmp = final + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None, template: Optional[dict] = None):
    """Restore (state, key, step). ``template`` (a pytree matching the saved
    state) restores the pytree structure and dtypes; without it the state
    comes back as the flat list of numpy leaves in ``jax.tree`` order."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory!r}")
    with np.load(_path(directory, step)) as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        key = jax.random.wrap_key_data(z["key"])
    if template is None:
        return leaves, key, step
    t_leaves, treedef = jax.tree.flatten(template)
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint at step {step} has {len(leaves)} leaves, the "
            f"template {len(t_leaves)}"
        )
    state = jax.tree.unflatten(
        treedef,
        [jax.numpy.asarray(x, dtype=jax.numpy.asarray(t).dtype)
         for x, t in zip(leaves, t_leaves)],
    )
    return state, key, step
