"""Spark hash contributions: CUDA kernels and their plain versions.

The port of ``spark_rapids_jni_tpu/ops/hash_pallas.py``'s kernels: the four
elementwise fixed-width ones, and the byte-string murmur3 kernel
(``mm_hash_bytes``, which also takes over the tail that the TPU path ran
beside its word kernel).  Each public ``*_cuda`` wrapper takes 1-D tensors of
values (for ``mm_hash_bytes``: a byte buffer and each row's start and length)
and a running hash or seed (a tensor with one per row, or a python int):

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

from typing import Dict, Optional, Sequence, Tuple, Union

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
    "mm_hash_bytes": 0,
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


def xx_round4(h, w32: torch.Tensor) -> torch.Tensor:
    """xxhash64's round over a 4-byte word ``w32`` (int64 holding the
    unsigned word); ``h`` int64 bits or int."""
    h = h ^ (w32 * signed64(XX_P1))
    return _rotl64(h, 23) * signed64(XX_P2) + signed64(XX_P3)


def xx_round8(h, w64: torch.Tensor) -> torch.Tensor:
    """xxhash64's round over an 8-byte word ``w64`` (int64 bits); ``h`` int64
    bits or int."""
    k1 = _rotl64(w64 * signed64(XX_P2), 31) * signed64(XX_P1)
    return _rotl64(h ^ k1, 27) * signed64(XX_P1) + signed64(XX_P4)


def xx_hash_fixed4_torch(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """xxhash64 of one 4-byte value.  ``v`` int32 bits, ``seed`` int64 bits or
    int -> int64 bits."""
    return _xx_finalize(xx_round4(_seed_plus(seed, XX_P5 + 4), _u32(v)))


def xx_hash_fixed8_torch(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """xxhash64 of one 8-byte value.  ``v`` int64 bits, ``seed`` int64 bits or
    int -> int64 bits."""
    return _xx_finalize(xx_round8(_seed_plus(seed, XX_P5 + 8), v))


def mm_hash_bytes_torch(chars: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                        h: Seed) -> torch.Tensor:
    """Spark Murmur3.hashUnsafeBytes contribution of ``chars[starts[i] :
    starts[i] + lens[i]]`` per row: one round per aligned little-endian word,
    one per sign-extended tail byte, then fmix(len).  ``chars`` uint8,
    ``starts``/``lens`` int32, ``h`` int32 bits or int -> int32 bits.

    Rows advance in lockstep over word index w, each masked by its own word
    count, so the loop runs to the longest row's words.  A span that does not
    lie within ``chars`` raises ValueError."""
    n = starts.shape[0]
    buf = chars if chars.numel() else torch.zeros(1, dtype=torch.uint8, device=chars.device)
    last = buf.numel() - 1
    s = starts.to(torch.int64)
    ln = lens.to(torch.int64)
    if n and bool(((s < 0) | (ln < 0) | (s + ln > chars.numel())).any()):
        raise ValueError("mm_hash_bytes: a span does not lie within chars")
    nwords = ln // 4
    hh = _hash_in32(h)
    if isinstance(hh, int):
        hh = torch.full((n,), hh, dtype=torch.int64, device=starts.device)
    lane = torch.arange(4, dtype=torch.int64, device=starts.device)
    for w in range(int(nwords.max()) if n else 0):
        idx = torch.clamp(s[:, None] + (4 * w) + lane, 0, last)
        word = _u32(buf[idx].view(torch.int32).flatten())  # little-endian
        hh = torch.where(w < nwords, _mm_mix_h1(hh, _mm_mix_k1(word)), hh)
    tail = s + 4 * nwords
    for j in range(3):
        b = buf[torch.clamp(tail + j, 0, last)].to(torch.int64)
        sbyte = ((b ^ 0x80) - 0x80) & M32  # the byte as a signed int, as u32 bits
        hh = torch.where(4 * nwords + j < ln, _mm_mix_h1(hh, _mm_mix_k1(sbyte)), hh)
    return _as_int32(_mm_fmix(hh, ln))


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


def _launch(name: str, fn_name: str, inputs: Sequence[torch.Tensor],
            aux: Optional[torch.Tensor], scalar: int, out_dtype: torch.dtype,
            n: int) -> torch.Tensor:
    """Launch ``fn_name(*inputs, aux or NULL, scalar, out, n, stream)`` on
    the current stream of the inputs' card; returns ``out[n]``."""
    from spark_rapids_jni_tpu_torch.ops import _build

    if not all(t.is_contiguous() for t in inputs) or (
            aux is not None and not aux.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    dev = inputs[0].device
    out = torch.empty((n,), dtype=out_dtype, device=dev)
    if n == 0:
        return out
    fn = getattr(_build.library(), fn_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in inputs), None if aux is None else aux.data_ptr(),
                scalar, out.data_ptr(), n, stream)
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
    return _launch("mm_hash_int", "srt_mm_hash_int", [v], hv, hs & M32, torch.int32,
                   v.shape[0])


def mm_hash_long_cuda(v: torch.Tensor, h: Seed) -> torch.Tensor:
    """Port of hash_pallas.mm_hash_long_pallas: int64 values, int32-bit
    running hash (tensor or int) -> int32 bits."""
    _check_values("mm_hash_long", v, torch.int64)
    hv, hs = _check_aux("mm_hash_long", h, v, torch.int32)
    if v.device.type == "cpu":
        return mm_hash_long_torch(v, h)
    return _launch("mm_hash_long", "srt_mm_hash_long", [v], hv, hs & M32, torch.int32,
                   v.shape[0])


def xx_hash_fixed4_cuda(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Port of hash_pallas.xx_hash_fixed4_pallas: int32 value bits, int64-bit
    seed (tensor or int) -> int64 bits."""
    _check_values("xx_hash_fixed4", v, torch.int32)
    sv, ss = _check_aux("xx_hash_fixed4", seed, v, torch.int64)
    if v.device.type == "cpu":
        return xx_hash_fixed4_torch(v, seed)
    return _launch("xx_hash_fixed4", "srt_xx_hash_fixed4", [v], sv, ss & M64, torch.int64,
                   v.shape[0])


def xx_hash_fixed8_cuda(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Port of hash_pallas.xx_hash_fixed8_pallas: int64 value bits, int64-bit
    seed (tensor or int) -> int64 bits."""
    _check_values("xx_hash_fixed8", v, torch.int64)
    sv, ss = _check_aux("xx_hash_fixed8", seed, v, torch.int64)
    if v.device.type == "cpu":
        return xx_hash_fixed8_torch(v, seed)
    return _launch("xx_hash_fixed8", "srt_xx_hash_fixed8", [v], sv, ss & M64, torch.int64,
                   v.shape[0])


def mm_hash_bytes_cuda(chars: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                       h: Seed) -> torch.Tensor:
    """Port of hash_pallas.mm_bytes_words_pallas with hashing._mm_bytes_tail:
    the whole murmur3 hashUnsafeBytes contribution of ``chars[starts[i] :
    starts[i] + lens[i]]`` per row.  ``chars`` uint8, ``starts``/``lens``
    int32, ``h`` int32-bit running hash (tensor or int) -> int32 bits.

    Every span must lie within ``chars``.  The plain version checks that; on
    the card it is not checked per launch, which would cost a reduction and
    a host sync each time.  The spans the hash API derives come from columns
    whose offsets were checked where the column was built."""
    _check_values("mm_hash_bytes", chars, torch.uint8)
    _check_values("mm_hash_bytes", starts, torch.int32)
    _check_values("mm_hash_bytes", lens, torch.int32)
    if lens.shape != starts.shape:
        raise TypeError(f"mm_hash_bytes: lens of shape {tuple(lens.shape)}, starts of "
                        f"shape {tuple(starts.shape)}")
    if not chars.device == starts.device == lens.device:
        raise ValueError(f"mm_hash_bytes: chars on {chars.device}, starts on "
                         f"{starts.device}, lens on {lens.device}")
    hv, hs = _check_aux("mm_hash_bytes", h, starts, torch.int32)
    if starts.device.type == "cpu":
        return mm_hash_bytes_torch(chars, starts, lens, h)
    return _launch("mm_hash_bytes", "srt_mm_hash_bytes", [chars, starts, lens], hv,
                   hs & M32, torch.int32, starts.shape[0])
