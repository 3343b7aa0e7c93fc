"""Fixed-width Spark hash contributions: CUDA kernels and their plain versions.

The port of ``spark_rapids_jni_tpu/ops/hash_pallas.py``'s four elementwise
kernels.  Each public ``*_cuda`` wrapper takes a 1-D tensor of values and a
running hash or seed (a tensor of the same length, or a python int):

- on a CUDA tensor it launches its kernel from ``csrc/hash_kernels.cu``
  (built on first use, see ``_build``) on the current stream, counts the
  launch in :data:`launches`, and raises if the launch fails;
- on a CPU tensor it runs the ``*_torch`` plain version beside it, because
  the tensor lies on the CPU, and launches nothing.

Unsigned words are carried in signed tensors with the same bits: u32 hashes
in int32, u64 hashes and seeds in int64 (torch's unsigned types lack ``+``,
shifts and ``%``).  The plain versions compute in int64, masking u32 values
to their low 32 bits, and rely on int64 ``*`` and ``+`` wrapping modulo 2**64.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

Seed = Union[int, torch.Tensor]

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF

# murmur3 constants (Spark Murmur3_x86_32)
_MM_C1 = 0xCC9E2D51
_MM_C2 = 0x1B873593

# xxhash64 primes (xxhash64.cu:188-192)
XX_P1 = 0x9E3779B185EBCA87
XX_P2 = 0xC2B2AE3D27D4EB4F
XX_P3 = 0x165667B19E3779F9
XX_P4 = 0x85EBCA77C2B2AE63
XX_P5 = 0x27D4EB2F165667C5

#: kernel launches per wrapper, counted only where a kernel is launched
launches: Dict[str, int] = {
    "xx_hash_fixed8": 0,
    "mm_hash_long": 0,
    "mm_hash_int": 0,
    "xx_hash_fixed4": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def signed64(x: int) -> int:
    """The int64 with the bits of ``x mod 2**64``."""
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def signed32(x: int) -> int:
    """The int32 with the bits of ``x mod 2**32``."""
    x &= M32
    return x - (1 << 32) if x >> 31 else x


# ---- plain versions: int64 tensor arithmetic --------------------------------


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 holding the unsigned value."""
    return t.to(torch.int64) & M32


def _as_int32(t: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value -> int32 with the same bits."""
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32)


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _shr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr64(x, 64 - r)


def _mm_mix_k1(k1):
    k1 = (k1 * _MM_C1) & M32
    k1 = _rotl32(k1, 15)
    return (k1 * _MM_C2) & M32


def _mm_mix_h1(h1, k1):
    h1 = h1 ^ k1
    h1 = _rotl32(h1, 13)
    return (h1 * 5 + 0xE6546B64) & M32


def _mm_fmix(h, length: int):
    h = h ^ length
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _xx_finalize(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr64(h, 33)
    h = h * signed64(XX_P2)
    h = h ^ _shr64(h, 29)
    h = h * signed64(XX_P3)
    return h ^ _shr64(h, 32)


def _hash_in32(h: Seed):
    return h & M32 if isinstance(h, int) else _u32(h)


def _seed_plus(seed: Seed, c: int):
    """seed + c modulo 2**64, as int64 bits (python int or tensor)."""
    if isinstance(seed, int):
        return signed64(seed + c)
    return seed + signed64(c)


def mm_hash_int_torch(v: torch.Tensor, h: Seed) -> torch.Tensor:
    """Spark Murmur3.hashInt contribution: one mix round + fmix(4).
    ``v`` int32, ``h`` int32 bits or int -> int32 bits."""
    out = _mm_fmix(_mm_mix_h1(_hash_in32(h), _mm_mix_k1(_u32(v))), 4)
    return _as_int32(out)


def mm_hash_long_torch(v: torch.Tensor, h: Seed) -> torch.Tensor:
    """Spark Murmur3.hashLong contribution: the low word's round, the high
    word's round, fmix(8).  ``v`` int64, ``h`` int32 bits or int -> int32."""
    low = v & M32
    high = (v >> 32) & M32
    hh = _mm_mix_h1(_hash_in32(h), _mm_mix_k1(low))
    hh = _mm_mix_h1(hh, _mm_mix_k1(high))
    return _as_int32(_mm_fmix(hh, 8))


def xx_hash_fixed4_torch(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """xxhash64 of one 4-byte value.  ``v`` int32 bits, ``seed`` int64 bits or
    int -> int64 bits."""
    h = _seed_plus(seed, XX_P5 + 4)
    h = h ^ (_u32(v) * signed64(XX_P1))
    h = _rotl64(h, 23) * signed64(XX_P2) + signed64(XX_P3)
    return _xx_finalize(h)


def xx_hash_fixed8_torch(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """xxhash64 of one 8-byte value.  ``v`` int64 bits, ``seed`` int64 bits or
    int -> int64 bits."""
    h = _seed_plus(seed, XX_P5 + 8)
    k1 = v * signed64(XX_P2)
    k1 = _rotl64(k1, 31) * signed64(XX_P1)
    h = h ^ k1
    h = _rotl64(h, 27) * signed64(XX_P1) + signed64(XX_P4)
    return _xx_finalize(h)


# ---- wrappers ---------------------------------------------------------------


def _check_values(name: str, v: torch.Tensor, dtype: torch.dtype) -> None:
    if not isinstance(v, torch.Tensor) or v.dtype != dtype or v.dim() != 1:
        got = f"{v.dtype} of shape {tuple(v.shape)}" if isinstance(v, torch.Tensor) \
            else type(v).__name__
        raise TypeError(f"{name}: values must be a 1-D {dtype} tensor, got {got}")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {v.device} are not supported")


def _check_aux(name: str, a: Seed, v: torch.Tensor,
               dtype: torch.dtype) -> Tuple[Optional[torch.Tensor], int]:
    """(per-row tensor or None, scalar) for a seed or running hash."""
    if isinstance(a, int):
        return None, a
    if not isinstance(a, torch.Tensor) or a.dtype != dtype or a.shape != v.shape:
        raise TypeError(f"{name}: seed/hash must be an int or a {dtype} tensor of "
                        f"shape {tuple(v.shape)}")
    if a.device != v.device:
        raise ValueError(f"{name}: seed/hash on {a.device}, values on {v.device}")
    return a, 0


def _launch(name: str, fn_name: str, v: torch.Tensor, aux: Optional[torch.Tensor],
            scalar: int, out_dtype: torch.dtype) -> torch.Tensor:
    from spark_rapids_jni_tpu_torch.ops import _build

    if not v.is_contiguous() or (aux is not None and not aux.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    n = v.shape[0]
    out = torch.empty((n,), dtype=out_dtype, device=v.device)
    if n == 0:
        return out
    fn = getattr(_build.library(), fn_name)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = fn(v.data_ptr(), None if aux is None else aux.data_ptr(), scalar,
                out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    launches[name] += 1
    return out


def mm_hash_int_cuda(v: torch.Tensor, h: Seed) -> torch.Tensor:
    """Port of hash_pallas.mm_hash_int_pallas: int32 values, int32-bit
    running hash (tensor or int) -> int32 bits."""
    _check_values("mm_hash_int", v, torch.int32)
    hv, hs = _check_aux("mm_hash_int", h, v, torch.int32)
    if v.device.type == "cpu":
        return mm_hash_int_torch(v, h)
    return _launch("mm_hash_int", "srt_mm_hash_int", v, hv, hs & M32, torch.int32)


def mm_hash_long_cuda(v: torch.Tensor, h: Seed) -> torch.Tensor:
    """Port of hash_pallas.mm_hash_long_pallas: int64 values, int32-bit
    running hash (tensor or int) -> int32 bits."""
    _check_values("mm_hash_long", v, torch.int64)
    hv, hs = _check_aux("mm_hash_long", h, v, torch.int32)
    if v.device.type == "cpu":
        return mm_hash_long_torch(v, h)
    return _launch("mm_hash_long", "srt_mm_hash_long", v, hv, hs & M32, torch.int32)


def xx_hash_fixed4_cuda(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Port of hash_pallas.xx_hash_fixed4_pallas: int32 value bits, int64-bit
    seed (tensor or int) -> int64 bits."""
    _check_values("xx_hash_fixed4", v, torch.int32)
    sv, ss = _check_aux("xx_hash_fixed4", seed, v, torch.int64)
    if v.device.type == "cpu":
        return xx_hash_fixed4_torch(v, seed)
    return _launch("xx_hash_fixed4", "srt_xx_hash_fixed4", v, sv, ss & M64, torch.int64)


def xx_hash_fixed8_cuda(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Port of hash_pallas.xx_hash_fixed8_pallas: int64 value bits, int64-bit
    seed (tensor or int) -> int64 bits."""
    _check_values("xx_hash_fixed8", v, torch.int64)
    sv, ss = _check_aux("xx_hash_fixed8", seed, v, torch.int64)
    if v.device.type == "cpu":
        return xx_hash_fixed8_torch(v, seed)
    return _launch("xx_hash_fixed8", "srt_xx_hash_fixed8", v, sv, ss & M64, torch.int64)
