"""Plan-level execution of whole query pipelines (PyTorch port of ``plans/``).

- :mod:`plans.ir` -- the hashable plan vocabulary, a copy of the JAX
  package's;
- :mod:`plans.compiler` -- builds a plan into one executor over its flat
  inputs, run eagerly on tensors, summed over the data axis under a mesh;
- :mod:`plans.cache` -- executors keyed on (plan structure, mesh, dtype
  signature, pow2 batch bucket), with hit/miss/trace/execute counters;
- :mod:`plans.runtime` -- pad, upload, run and download one execution.
"""

from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.cache import CompiledPlan, PlanCache, plan_cache
from spark_rapids_jni_tpu_torch.plans.compiler import (
    cached_compile,
    compile_plan,
    input_signature,
    output_names,
)
from spark_rapids_jni_tpu_torch.plans.runtime import (
    combine_outputs,
    compiled_plan_for,
    execute_plan,
    input_signature_raw,
    pad_tables,
    plan_inputs,
    plan_working_set_bytes,
    split_scan_tables,
)

__all__ = [
    "ir",
    "CompiledPlan",
    "PlanCache",
    "plan_cache",
    "cached_compile",
    "compile_plan",
    "input_signature",
    "output_names",
    "combine_outputs",
    "compiled_plan_for",
    "execute_plan",
    "input_signature_raw",
    "pad_tables",
    "plan_inputs",
    "plan_working_set_bytes",
    "split_scan_tables",
]
