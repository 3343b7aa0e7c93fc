"""Plan-level execution of whole query pipelines (PyTorch port of ``plans/``).

- :mod:`plans.ir` -- the hashable plan vocabulary, a copy of the JAX
  package's;
- :mod:`plans.compiler` -- builds a plan into one executor over its flat
  inputs, run eagerly on tensors, summed over the data axis under a mesh;
- :mod:`plans.cache` -- executors keyed on (plan structure, mesh, dtype
  signature, pow2 batch bucket), with hit/miss/trace/execute counters;
- :mod:`plans.runtime` -- pad, upload, run and download one execution, and
  :func:`run_governed_plan`, the memory-governed bracket around it (one
  admission, one retry/split boundary, one flight task per plan);
- :mod:`plans.window` -- sort ranks, sorted runs and the window functions
  of the order tier;
- :mod:`plans.optimizer` -- the stats-driven rule rewriter, a copy of the
  JAX package's;
- :mod:`plans.rcache` -- the governed multi-tier result cache, keyed on
  (plan or handler, input content, bucket signature, table versions).
"""

from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.cache import CompiledPlan, PlanCache, plan_cache
from spark_rapids_jni_tpu_torch.plans.compiler import (
    EXCHANGE_SOURCE,
    RaggedProgram,
    cached_compile,
    cached_ragged_compile,
    compile_plan,
    compile_ragged,
    emit_exchange_partitions,
    emit_range_partitions,
    eval_post,
    input_signature,
    output_names,
    sample_range_splitters,
    split_exchange_plan,
)
from spark_rapids_jni_tpu_torch.plans.optimizer import optimize_plan, rewrite_plan
from spark_rapids_jni_tpu_torch.plans.rcache import ResultCache, result_cache
from spark_rapids_jni_tpu_torch.plans.runtime import (
    combine_outputs,
    compiled_plan_for,
    execute_plan,
    input_signature_raw,
    pad_tables,
    plan_inputs,
    plan_upload_stats,
    plan_working_set_bytes,
    run_governed_plan,
    split_scan_tables,
    upload_inputs,
)

__all__ = [
    "ir",
    "CompiledPlan",
    "PlanCache",
    "RaggedProgram",
    "ResultCache",
    "plan_cache",
    "result_cache",
    "cached_compile",
    "cached_ragged_compile",
    "compile_plan",
    "compile_ragged",
    "input_signature",
    "output_names",
    "EXCHANGE_SOURCE",
    "emit_exchange_partitions",
    "emit_range_partitions",
    "eval_post",
    "sample_range_splitters",
    "split_exchange_plan",
    "optimize_plan",
    "rewrite_plan",
    "combine_outputs",
    "compiled_plan_for",
    "execute_plan",
    "input_signature_raw",
    "pad_tables",
    "plan_inputs",
    "plan_working_set_bytes",
    "run_governed_plan",
    "split_scan_tables",
    "plan_upload_stats",
    "upload_inputs",
]
