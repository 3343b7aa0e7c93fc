"""SegmentAgg's segment sum: a CUDA kernel and its plain version.

``segment_sum(values, ids, num_segments)`` is ``jax.ops.segment_sum``: the
sums of ``values`` by segment id, where a row whose id lies outside
``[0, num_segments)`` is dropped (the plan emitter gives masked rows id -1).

- On a CUDA tensor it launches ``srt_segment_sum`` from
  ``csrc/agg_kernels.cu`` (built on first use, see ``_build``) on the current
  stream into a zeroed grid it allocates, counts the launch in
  ``hash_cuda.launches["segment_sum"]`` (one counter for the whole kernel
  library), and raises if the launch fails.  A dropped row costs only the
  read of its id.  Values must be int32, int64, float32 or float64 (the
  aggregate dtypes of every SegmentAgg the port builds) and both inputs contiguous:
  anything else raises before the launch.
- On a CPU tensor it runs :func:`segment_sum_torch`, the plain version,
  because the tensor lies on the CPU, and launches nothing.  It takes every
  dtype ``index_add_`` takes, as the JAX reference does.
"""

from __future__ import annotations

import torch

from spark_rapids_jni_tpu_torch.ops import hash_cuda

#: value dtype -> the kernel's value code (csrc/agg_kernels.cu ``ValueCode``)
VALUE_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}


def segment_sum_torch(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: sums of ``values`` by segment id, where ids
    outside ``[0, num_segments)`` are dropped (``index_add_`` would raise on
    them): they go to one spare bucket past the end, which is cut off."""
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments + 1,), dtype=values.dtype, device=values.device)
    out.index_add_(0, torch.where(ok, ids, num_segments), values)
    return out[:-1]


def _check(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> None:
    """What the kernel takes: 1-D contiguous values of a dtype in
    :data:`VALUE_CODES`, integer ids of the same shape on the same device,
    and a grid of 0 or more segments."""
    if not isinstance(values, torch.Tensor) or values.dtype not in VALUE_CODES \
            or values.dim() != 1:
        got = f"{values.dtype} of shape {tuple(values.shape)}" \
            if isinstance(values, torch.Tensor) else type(values).__name__
        raise TypeError("segment_sum: values must be a 1-D int32, int64, float32 or "
                        f"float64 tensor, got {got}")
    if not isinstance(ids, torch.Tensor) or ids.shape != values.shape \
            or ids.dtype.is_floating_point or ids.dtype.is_complex:
        raise TypeError(f"segment_sum: ids must be an integer tensor of shape "
                        f"{tuple(values.shape)}")
    if ids.device != values.device:
        raise ValueError(f"segment_sum: ids on {ids.device}, values on {values.device}")
    if not (values.is_contiguous() and ids.is_contiguous()):
        raise ValueError("segment_sum: inputs must be contiguous")
    if num_segments < 0:
        raise ValueError(f"segment_sum: num_segments {num_segments} < 0")


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sums of ``values`` by segment id into ``[num_segments]`` of the
    values' dtype; ids outside ``[0, num_segments)`` are dropped."""
    if values.device.type != "cuda":
        return segment_sum_torch(values, ids, num_segments)
    from spark_rapids_jni_tpu_torch.ops import _build

    _check(values, ids, num_segments)
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    dev = values.device
    out = torch.zeros((num_segments,), dtype=values.dtype, device=dev)
    n = values.shape[0]
    if n == 0 or num_segments == 0:
        return out
    fn = _build.library().srt_segment_sum
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ids.data_ptr(), ids.element_size(), values.data_ptr(),
                VALUE_CODES[values.dtype], out.data_ptr(), n, int(num_segments), stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum: kernel launch failed with CUDA error {rc}")
    with hash_cuda._launches_lock:
        hash_cuda.launches["segment_sum"] += 1
    return out
