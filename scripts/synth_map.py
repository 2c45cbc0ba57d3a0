#!/usr/bin/env python
"""MAP-fit a model to a data file (≅ test/synth_map.py; SURVEY.md §3.2).
Supports sparse coupling (--lam) and cross-validated lambda (--xv).

  python scripts/synth_map.py -d results/synth_data.npz --model sparse_weighted_model -r results/
"""
import os, sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from theano_pyglm_tpu.cli import fit_map
from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache
from theano_pyglm_tpu.utils.io import parse_cmd_line_args

if __name__ == "__main__":
    enable_compile_cache()
    fit_map(parse_cmd_line_args(description=__doc__))
