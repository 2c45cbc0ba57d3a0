#!/usr/bin/env python
"""Sample a model from its prior and simulate spikes (≅ the reference's
test/generate_synth_data.py harness; SURVEY.md §3.1).

  python scripts/generate_synth_data.py --model sparse_weighted_model -N 10 -T 60 -r results/
"""
import os, sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from theano_pyglm_tpu.cli import generate_synth_data
from theano_pyglm_tpu.utils.compile_cache import enable_compile_cache
from theano_pyglm_tpu.utils.io import parse_cmd_line_args

if __name__ == "__main__":
    enable_compile_cache()
    generate_synth_data(parse_cmd_line_args(description=__doc__))
