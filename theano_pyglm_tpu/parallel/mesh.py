"""Device-mesh helpers — the replacement for the reference's
IPython.parallel client/hub/engine layer (SURVEY.md §2 "Distributed backend",
§5). There is no message-passing runtime to manage: parallel work is
expressed as sharded arrays over a ``jax.sharding.Mesh`` and XLA inserts the
collectives.

Two axes of parallelism exist in this model family (SURVEY.md §2):
  'chains'  — embarrassingly parallel MCMC chains (≅ one engine per chain);
  'neurons' — the per-neuron factorization of the likelihood
              (≅ one engine per neuron subset in parallel coord descent).
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["chain_mesh", "neuron_mesh", "shard_chains", "replicate"]


def _mesh(axis: str, n_devices: Optional[int]) -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    # Auto axis type = classic GSPMD: shardings are constraints, the
    # partitioner propagates the rest (jax 0.9 defaults to Explicit).
    return jax.make_mesh(
        (len(devs),), (axis,), devices=devs,
        axis_types=(jax.sharding.AxisType.Auto,),
    )


def chain_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over (up to) all local devices with axis name 'chains'."""
    return _mesh("chains", n_devices)


def neuron_mesh(n_devices: Optional[int] = None) -> Mesh:
    return _mesh("neurons", n_devices)


def shard_chains(tree, mesh: Mesh):
    """Place every leaf with its leading (chain) axis split over the mesh."""
    sharding = NamedSharding(mesh, P("chains"))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def replicate(tree, mesh: Mesh):
    """Replicate every leaf on all mesh devices (e.g. the data dict)."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
