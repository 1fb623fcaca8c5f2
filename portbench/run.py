#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cells, metrics and configurations
are named in ``BENCHMARK.json``; everything else lives under
``portbench/`` and is found by those names (``harness.py`` says how).
The run needs a CUDA card: without one it prints no result and exits 2.
Its last line on standard output is the result as one JSON object.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _environment() -> None:
    """Fixed cache directories inside the checkout, and no JAX through a
    library that would load it on its own."""
    build = os.path.join(ROOT, "build")
    os.environ["REPRO_PLAN_CACHE"] = os.path.join(build, "portbench_plans")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (ROOT, os.path.join(ROOT, "src")):
        if path not in sys.path:
            sys.path.insert(0, path)


if __name__ == "__main__":
    _environment()
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
