"""Spark hash contributions: CUDA kernels and their plain versions.

The port of ``spark_rapids_jni_tpu/ops/hash_pallas.py``'s kernels: the four
elementwise fixed-width ones, and the byte-string murmur3 kernel, which also
takes over the tail that the TPU path ran beside its word kernel, as three
entry points that read their bytes three ways: ``mm_hash_strings`` (a string
column's chars and Arrow offsets), ``mm_hash_bytes`` (a byte buffer and each
row's start and length) and ``mm_hash_decimal128`` (a DECIMAL128 column's
``hi``/``lo`` words, hashed as their Java bytes).  Each public ``*_cuda``
wrapper takes 1-D tensors of values and a running hash or seed (a tensor with
one per row, or a python int):

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

import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from spark_rapids_jni_tpu_torch.columnar.buckets import length_buckets

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

#: kernel launches per wrapper of the kernel library, this module's and
#: ``agg_cuda.segment_sum``'s, counted only where a kernel is launched (under
#: ``_launches_lock``: the serving engine and task threads launch at once)
launches: Dict[str, int] = {
    "xx_hash_fixed8": 0,
    "mm_hash_long": 0,
    "mm_hash_int": 0,
    "xx_hash_fixed4": 0,
    "mm_hash_strings": 0,
    "mm_hash_bytes": 0,
    "mm_hash_decimal128": 0,
    "segment_sum": 0,
}


_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
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


def _round32(h, k):
    return _mm_mix_h1(h, _mm_mix_k1(k))


def _funnel(cur: torch.Tensor, nxt: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """CUDA's ``__funnelshift_r(cur, nxt, sh)`` on u32 words held in int64:
    the 32 bits of ``nxt:cur`` from bit ``sh`` (0, 8, 16 or 24) up."""
    return (((nxt << 32) | cur) >> sh) & M32


def _word_buffer(chars: torch.Tensor) -> torch.Tensor:
    """``chars`` as int32 words, zero-filled to whole words: word q holds
    bytes 4q .. 4q+3, little-endian."""
    buf = torch.zeros(max(4, -(-chars.numel() // 4) * 4), dtype=torch.uint8,
                      device=chars.device)
    buf[:chars.numel()] = chars
    return buf.view(torch.int32)


def _mm_spans_class(words: torch.Tensor, s: torch.Tensor, ln: torch.Tensor,
                    hh: torch.Tensor, width: int) -> torch.Tensor:
    """``mm_hash_row`` of ``hash_kernels.cu`` over rows of at most ``width``
    bytes, in lockstep, before fmix: each word is the funnel shift of the two
    aligned words it straddles, and every next aligned word's position is
    clamped to the word that holds the row's last byte (on the card only the
    last full word's and the tail's are: before them the clamp never bites).
    ``s``/``ln`` int64 byte positions and lengths, ``hh`` u32 in int64."""
    top = words.numel() - 1

    def load(q):  # clamped only to stay in the buffer on rows that read nothing
        return _u32(words[torch.clamp(q, 0, top)])

    sh = (s & 3) * 8
    q0 = s >> 2
    qlast = (s + ln - 1) >> 2
    nw = ln >> 2
    steps = width // 4
    every = int(nw.min()) if s.numel() else 0  # words that every row of the class has
    chunk = max(1, (1 << 24) // max(1, s.numel()))  # words gathered at once
    for i0 in range(0, steps, chunk):
        c = min(chunk, steps - i0)
        q = q0[:, None] + torch.arange(i0, i0 + c + 1, device=s.device)
        w = load(torch.minimum(q, qlast[:, None]))
        k1 = _mm_mix_k1(_funnel(w[:, :-1], w[:, 1:], sh[:, None]))
        live = torch.arange(i0, i0 + c, device=s.device) < nw[:, None]
        for i in range(c):
            upd = _mm_mix_h1(hh, k1[:, i])
            hh = upd if i0 + i < every else torch.where(live[:, i], upd, hh)
    qt = torch.minimum(q0 + nw, qlast)  # the word that holds the first tail byte
    bits = _funnel(load(qt), load(torch.minimum(qt + 1, qlast)), sh)
    for j in range(3):
        b = (bits >> (8 * j)) & 0xFF
        sbyte = ((b ^ 0x80) - 0x80) & M32  # the byte as a signed int, as u32 bits
        hh = torch.where(j < (ln & 3), _round32(hh, sbyte), hh)
    return hh


def _mm_hash_spans(name: str, chars: torch.Tensor, s: torch.Tensor, ln: torch.Tensor,
                   h: Seed) -> torch.Tensor:
    """Spark Murmur3.hashUnsafeBytes contribution of ``chars[s[i] : s[i] +
    ln[i]]`` per row (int64 ``s``, ``ln``), walked one power-of-two length
    class at a time so that one long row does not set the number of steps for
    every row.  A span that does not lie within ``chars`` raises ValueError."""
    n = s.shape[0]
    if n and bool(((s < 0) | (ln < 0) | (s + ln > chars.numel())).any()):
        raise ValueError(f"{name}: a span does not lie within chars")
    hh = _hash_in32(h)
    hh = torch.full((n,), hh, dtype=torch.int64, device=s.device) if isinstance(hh, int) \
        else hh.clone()
    words = _word_buffer(chars)
    for width, rows in length_buckets(ln):
        hh[rows] = _mm_spans_class(words, s[rows], ln[rows], hh[rows], width)
    return _as_int32(_mm_fmix(hh, ln))


def mm_hash_bytes_torch(chars: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                        h: Seed) -> torch.Tensor:
    """Plain version of ``mm_hash_bytes``: Spark Murmur3.hashUnsafeBytes
    contribution of ``chars[starts[i] : starts[i] + lens[i]]`` per row (one
    round per aligned little-endian word, one per sign-extended tail byte,
    then fmix(len)).  ``chars`` uint8, ``starts``/``lens`` int32, ``h`` int32
    bits or int -> int32 bits.  A span outside ``chars`` raises ValueError."""
    return _mm_hash_spans("mm_hash_bytes", chars, starts.to(torch.int64),
                          lens.to(torch.int64), h)


def mm_hash_strings_torch(chars: torch.Tensor, offsets: torch.Tensor, h: Seed) -> torch.Tensor:
    """Plain version of ``mm_hash_strings``: the same contribution for row i
    = ``chars[offsets[i] : offsets[i+1]]`` of a string column.  ``chars``
    uint8, ``offsets`` int32 [n+1], ``h`` int32 bits or int -> int32 bits."""
    offs = offsets.to(torch.int64)
    return _mm_hash_spans("mm_hash_strings", chars, offs[:-1], offs[1:] - offs[:-1], h)


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """CUDA's ``__clzll`` of u64 bits held in int64 (64 for 0), by binary
    search over the leading bits."""
    n = torch.zeros_like(x)
    for r in (32, 16, 8, 4, 2, 1):
        zero = _shr64(x, 64 - r) == 0
        n = n + torch.where(zero, r, 0)
        x = torch.where(zero, x << r, x)
    return n + (x == 0).to(torch.int64)


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """CUDA's ``__byte_perm(x, 0, 0x0123)`` on u32 values held in int64."""
    return ((x & 0xFF) << 24) | (((x >> 8) & 0xFF) << 16) | (((x >> 16) & 0xFF) << 8) \
        | ((x >> 24) & 0xFF)


def mm_hash_decimal128_torch(hi: torch.Tensor, lo: torch.Tensor, h: Seed) -> torch.Tensor:
    """Plain version of ``mm_hash_decimal128``: Spark Murmur3.hashUnsafeBytes
    contribution of the Java bytes of each 128-bit value ``hi:lo``
    (``BigDecimal.unscaledValue().toByteArray()``), built as the kernel builds
    them: the length from the count of leading bits, the value shifted to the
    top of 128 bits, big-endian words as byte-swapped 32-bit lanes.  ``hi``
    int64, ``lo`` int64 holding the low word's bits, ``h`` int32 bits or int
    -> int32 bits."""
    sign = hi >> 63
    mh, ml = hi ^ sign, lo ^ sign
    clz = torch.where(mh != 0, _clz64(mh), 64 + _clz64(ml))
    length = (128 - clz + 8) >> 3  # significant bits + sign, in bytes: 1..16
    s = 8 * (16 - length)
    # the kernel's three cases, every shift kept in 0..63
    mid = torch.clamp(s, 1, 63)
    rmid = 64 - mid
    th_mid = (hi << mid) | ((lo >> rmid) & ((torch.ones_like(lo) << (64 - rmid)) - 1))
    th = torch.where(s == 0, hi, torch.where(s >= 64, lo << torch.clamp(s - 64, 0, 63), th_mid))
    tl = torch.where(s == 0, lo, torch.where(s >= 64, 0, lo << mid))
    lanes = [_shr64(th, 32), th & M32, _shr64(tl, 32), tl & M32]
    nw = length >> 2
    hh = _hash_in32(h)
    if isinstance(hh, int):
        hh = torch.full(hi.shape, hh, dtype=torch.int64, device=hi.device)
    for w in range(4):
        hh = torch.where(w < nw, _round32(hh, _bswap32(lanes[w])), hh)
    tail = torch.where(nw == 0, lanes[0], torch.where(nw == 1, lanes[1],
                                                      torch.where(nw == 2, lanes[2], lanes[3])))
    for j in range(3):
        b = (tail >> (24 - 8 * j)) & 0xFF
        hh = torch.where(j < (length & 3), _round32(hh, ((b ^ 0x80) - 0x80) & M32), hh)
    return _as_int32(_mm_fmix(hh, length))


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
    with _launches_lock:
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


def _check_same_device(name: str, *tensors: torch.Tensor) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on " + ", ".join(str(t.device) for t in tensors))


def mm_hash_strings_cuda(chars: torch.Tensor, offsets: torch.Tensor, h: Seed) -> torch.Tensor:
    """Port of hash_pallas.mm_bytes_words_pallas with hashing._mm_bytes_tail
    for a string or binary column: the whole murmur3 hashUnsafeBytes
    contribution of row i = ``chars[offsets[i] : offsets[i+1]]``.  ``chars``
    uint8, ``offsets`` int32 [n+1], ``h`` int32-bit running hash (tensor of n
    or int) -> int32 bits [n].

    The offsets must start at 0 or more, never decrease and end within
    ``chars``.  The plain version checks that; on the card it is not checked
    per launch (a reduction and a host sync each time): columns check their
    offsets where they are built."""
    _check_values("mm_hash_strings", chars, torch.uint8)
    _check_values("mm_hash_strings", offsets, torch.int32)
    if offsets.shape[0] < 1:
        raise TypeError("mm_hash_strings: offsets must hold n+1 >= 1 entries")
    _check_same_device("mm_hash_strings", chars, offsets)
    hv, hs = _check_aux("mm_hash_strings", h, offsets[1:], torch.int32)
    if offsets.device.type == "cpu":
        return mm_hash_strings_torch(chars, offsets, h)
    return _launch("mm_hash_strings", "srt_mm_hash_strings", [chars, offsets], hv,
                   hs & M32, torch.int32, offsets.shape[0] - 1)


def mm_hash_bytes_cuda(chars: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                       h: Seed) -> torch.Tensor:
    """Port of hash_pallas.mm_bytes_words_pallas with hashing._mm_bytes_tail
    for arbitrary spans: the whole murmur3 hashUnsafeBytes contribution of
    ``chars[starts[i] : starts[i] + lens[i]]`` per row.  ``chars`` uint8,
    ``starts``/``lens`` int32, ``h`` int32-bit running hash (tensor or int)
    -> int32 bits.

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
    _check_same_device("mm_hash_bytes", chars, starts, lens)
    hv, hs = _check_aux("mm_hash_bytes", h, starts, torch.int32)
    if starts.device.type == "cpu":
        return mm_hash_bytes_torch(chars, starts, lens, h)
    return _launch("mm_hash_bytes", "srt_mm_hash_bytes", [chars, starts, lens], hv,
                   hs & M32, torch.int32, starts.shape[0])


def mm_hash_decimal128_cuda(hi: torch.Tensor, lo: torch.Tensor, h: Seed) -> torch.Tensor:
    """Port of hash_pallas.mm_bytes_words_pallas with hashing._mm_bytes_tail
    for a DECIMAL128 column: the murmur3 hashUnsafeBytes contribution of each
    value's Java bytes, built on the card from ``hi`` (int64) and ``lo``
    (int64 holding the low word's bits); ``h`` int32-bit running hash (tensor
    or int) -> int32 bits."""
    _check_values("mm_hash_decimal128", hi, torch.int64)
    _check_values("mm_hash_decimal128", lo, torch.int64)
    if lo.shape != hi.shape:
        raise TypeError(f"mm_hash_decimal128: lo of shape {tuple(lo.shape)}, hi of "
                        f"shape {tuple(hi.shape)}")
    _check_same_device("mm_hash_decimal128", hi, lo)
    hv, hs = _check_aux("mm_hash_decimal128", h, hi, torch.int32)
    if hi.device.type == "cpu":
        return mm_hash_decimal128_torch(hi, lo, h)
    return _launch("mm_hash_decimal128", "srt_mm_hash_decimal128", [hi, lo], hv, hs & M32,
                   torch.int32, hi.shape[0])
