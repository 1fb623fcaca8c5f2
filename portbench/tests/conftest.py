"""The benchmark's CPU tests: ``python -m pytest portbench/tests`` from
the root of the repository."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# the cells at sizes a CPU test holds: the same runners, generators and
# references as the full-size runs
SMALL = {
    "pagerank.m64-16x4": {"config": {"vertices": 4096, "edges": 40000},
                          "traffic": {"trace_units": 2}},
    "minibatch.m64-16x4": {"config": {"vertices": 1 << 14},
                           "traffic": {"edges_per_node": 1024,
                                       "capacity": 2048, "pool": 2,
                                       "trace_units": 2}},
    "train.granite-moe-3b": {
        "config": {"hidden_size": 64, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "num_hidden_layers": 2,
                   "num_local_experts": 8, "num_experts_per_tok": 2,
                   "intermediate_size": 32, "vocab_size": 500,
                   # float32: the port's gaps to the float32 reference are
                   # then round-off, under the cell's own limits
                   "torch_dtype": "float32"},
        "traffic": {"rows_per_position": 2, "seq": 32, "batches": 8,
                    "trace_units": 1}},
}


import copy  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def small():
    """``small(cell)``: a fresh copy of the cell's small-size overrides."""
    return lambda cell: copy.deepcopy(SMALL[cell])
