#!/usr/bin/env python
"""Full Bayesian MCMC on a data file (≅ test/synth_mcmc.py; SURVEY.md §3.3).
Use --n_chains > 1 for device-parallel chains.

  python scripts/synth_mcmc.py -d results/synth_data.npz --model sparse_weighted_model \
      --n_samples 1000 --n_chains 4 -r results/
"""
import os, sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from theano_pyglm_tpu.cli import fit_mcmc
from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache
from theano_pyglm_tpu.utils.io import parse_cmd_line_args

if __name__ == "__main__":
    enable_compile_cache()
    fit_mcmc(parse_cmd_line_args(description=__doc__))
