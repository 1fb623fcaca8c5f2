"""No JAX anywhere in the benchmark, no port in its references, and a
run with no card or no port prints no result."""
import ast
import os
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT
BENCH = os.path.join(ROOT, "portbench")


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".", 1)[0]


def _sources(where):
    for dirpath, _, files in os.walk(where):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_top_level_names_are_compared_whole():
    mods = {"repro_torch", "repro_torch.core.api", "reproducible", "jaxtyping",
            "numpy"}
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods | {"repro.core", "jax",
                                             "jaxlib.xla", "flax.linen"}) == \
        ["flax.linen", "jax", "jaxlib.xla", "repro.core"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        bad = set(_top_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_references_import_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert "repro_torch" not in set(_top_imports(path)), path
    # nor what they import from the benchmark
    for name in ("generate.py", "weights.py"):
        assert "repro_torch" not in set(_top_imports(os.path.join(BENCH, name)))


def _run(args, cwd, pre=""):
    code = (f"import sys; sys.argv = ['run.py'] + {args!r}; {pre}"
            "import runpy; runpy.run_path('portbench/run.py', run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_the_run_prints_no_result():
    out = _run(["--workload", "pagerank.m64-16x4", "--seed", "1",
                "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0 and out.stdout.strip() == "", out
    assert "CUDA" in out.stderr


def test_in_a_checkout_of_the_benchmark_alone_the_run_prints_no_result(
        tmp_path):
    """Only ``BENCHMARK.json`` and ``portbench/``: even with a card
    pretended, the port is not there and the run ends without a result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    pretend = ("import torch; torch.cuda.is_available = lambda: True; "
               "torch.cuda.device_count = lambda: 4; ")
    out = _run(["--workload", "pagerank.m64-16x4", "--seed", "1",
                "--seconds", "1", "--trace", "0"], str(tmp_path), pretend)
    assert out.returncode != 0 and out.stdout.strip() == "", out
    assert "repro_torch" in out.stderr
