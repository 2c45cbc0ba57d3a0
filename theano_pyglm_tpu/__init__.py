"""theano_pyglm_tpu — a JAX network-GLM framework for neural spike trains.

A ground-up JAX/XLA rebuild of the capabilities of
``slinderman/theano_pyglm`` (Theano-based Bayesian network GLMs for spike
trains; see SURVEY.md for the full capability inventory). Not a port: the
reference's tree of symbolic Theano components becomes a pytree of parameters
plus pure, jit-compiled functions; per-neuron task parallelism becomes ``vmap``
over the neuron axis; multi-chain MCMC is sharded over accelerator devices via
``jax.sharding``.

Layer map (mirrors SURVEY.md §1):
  ops/        — bases, causal basis convolution, log-densities (≅ pyglm/utils)
  models/     — component builders, network priors, population model, zoo
                (≅ pyglm/components, pyglm/glm.py, pyglm/population.py,
                 pyglm/models)
  inference/  — MAP coordinate descent, HMC, collapsed Gibbs, MCMC driver
                (≅ pyglm/inference)
  parallel/   — device-mesh chain/neuron sharding (≅ IPython.parallel layer)
  utils/      — io, sta, metrics, checkpointing (≅ pyglm/utils, plotting)
"""

__version__ = "0.1.0"

from theano_pyglm_tpu.models.zoo import make_model  # noqa: F401
from theano_pyglm_tpu.models.population import Population  # noqa: F401
