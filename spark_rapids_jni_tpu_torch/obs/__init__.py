"""Observability (PyTorch port of ``obs/``): so far the dispatch seam and the
governance flight recorder, copies of the JAX package's modules that memory
governance records into, and the per-op phase timers the row conversion
fills.  The profiler, tracing and timing come with the port's serving and
observability layer."""

from spark_rapids_jni_tpu_torch.obs import flight, phases, seam

__all__ = ["flight", "phases", "seam"]
