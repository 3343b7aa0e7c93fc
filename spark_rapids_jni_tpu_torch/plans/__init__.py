"""Plan-level execution of whole query pipelines (PyTorch port of ``plans/``).

- :mod:`plans.ir` -- the hashable plan vocabulary, a copy of the JAX
  package's;
- :mod:`plans.compiler` -- builds a plan into one executor over its flat
  inputs, run eagerly on tensors, summed over the data axis under a mesh;
- :mod:`plans.cache` -- executors keyed on (plan structure, mesh, dtype
  signature, pow2 batch bucket), with hit/miss/trace/execute counters;
- :mod:`plans.runtime` -- pad, upload, run and download one execution, and
  :func:`run_governed_plan`, the memory-governed bracket around it (one
  admission, one retry/split boundary, one flight task per plan).
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
    plan_retry_stats,
    plan_working_set_bytes,
    reset_plan_retry_stats,
    run_governed_plan,
    split_scan_tables,
    suggested_presplit_depth,
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
    "plan_retry_stats",
    "plan_working_set_bytes",
    "reset_plan_retry_stats",
    "run_governed_plan",
    "split_scan_tables",
    "suggested_presplit_depth",
]
