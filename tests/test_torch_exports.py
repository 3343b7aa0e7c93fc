"""The port's subpackages export every name the JAX package's export.

For each subpackage ``__init__`` with an ``__all__``, every name in the JAX
package's ``__all__`` is in the port's and resolves there, and the port's
constants equal the JAX package's.  The port may export more.  The only
names it leaves out are the sharding helpers of ``parallel``, which place
JAX arrays on a JAX mesh and have no torch meaning.  Each of the subpackages
that import one another also imports first in a fresh interpreter, with no
cycle, and without JAX.
"""

import importlib
import os
import subprocess
import sys

import pytest

SUBPACKAGES = ["columnar", "io", "mem", "models", "obs", "ops", "parallel", "plans", "serve",
               "utils"]
NO_TORCH_MEANING = {"parallel": {"data_sharding", "model_sharding", "replicated", "shard_map"}}
FIRST_IMPORTS = ["plans", "serve", "columnar", "parallel", "mem"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _constant(v):
    return isinstance(v, (bool, int, float, str, bytes)) or (
        isinstance(v, tuple) and all(_constant(x) for x in v))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_every_jax_name(sub):
    jax_pkg = importlib.import_module(f"spark_rapids_jni_tpu.{sub}")
    port = importlib.import_module(f"spark_rapids_jni_tpu_torch.{sub}")
    left_out = NO_TORCH_MEANING.get(sub, set())
    assert left_out <= set(jax_pkg.__all__)  # the exceptions name real JAX exports
    assert len(set(port.__all__)) == len(port.__all__)
    for name in port.__all__:
        getattr(port, name)
    missing = sorted(set(jax_pkg.__all__) - left_out - set(port.__all__))
    assert not missing, f"{sub}: the port does not export {missing}"
    for name in sorted(set(jax_pkg.__all__) - left_out):
        want = getattr(jax_pkg, name)
        if _constant(want):
            assert getattr(port, name) == want, f"{sub}.{name}"


def test_decimal_precision_limits_are_spark_s():
    from spark_rapids_jni_tpu_torch import columnar

    assert (columnar.MAX_DECIMAL_PRECISION, columnar.MAX_DECIMAL64_PRECISION,
            columnar.MAX_DECIMAL32_PRECISION) == (38, 18, 9)


@pytest.mark.parametrize("sub", FIRST_IMPORTS)
def test_subpackage_imports_first_without_jax(sub):
    code = (f"import sys, spark_rapids_jni_tpu_torch.{sub}\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m.split('.')[0] == 'spark_rapids_jni_tpu')\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
