"""No run loads JAX or the JAX package, compared by whole top-level names
(the port's name begins with the JAX package's), and the plain references
load nothing of the port."""

import json
import os
import subprocess
import sys

from nds_bench.core.imports import forbidden_modules
from nds_bench.core.registry import ROOT


def test_top_level_names_compared_whole():
    assert forbidden_modules(["spark_rapids_jni_tpu_torch", "spark_rapids_jni_tpu_torch.ops",
                              "jaxtyping", "flax_like", "numpy"]) == []
    assert forbidden_modules(["spark_rapids_jni_tpu.ops.hashing", "jax._src.api", "jaxlib",
                              "flax.linen"]) == ["flax", "jax", "jaxlib", "spark_rapids_jni_tpu"]


def _python(code: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _python(
        "import sys, json, time; sys.path.insert(0, '.')\n"
        "from nds_bench.tests.nds_bench_tiny import run_tiny, tiny_cell\n"
        "from nds_bench.core.imports import forbidden_modules\n"
        "res = [run_tiny(tiny_cell(w))['correct'] for w in ('q97.tasks', 'q3.tasks')]\n"
        "print(json.dumps({'correct': res, 'bad': forbidden_modules(sys.modules),"
        " 'port': 'spark_rapids_jni_tpu_torch.models.q97' in sys.modules}))")
    assert got == {"correct": [True, True], "bad": [], "port": True}


def test_references_load_nothing_of_the_port():
    got = _python(
        "import sys, json; sys.path.insert(0, '.')\n"
        "from nds_bench.core.registry import BENCH_DIR, load_module\n"
        "for q in ('q97', 'q3'):\n"
        "    load_module(BENCH_DIR / 'reference' / f'{q}.py', 'ref_' + q)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'spark_rapids_jni_tpu_torch', 'spark_rapids_jni_tpu', 'jax'})))")
    assert got == []
