"""Spark ``parse_url``: protocol/host/query/query-param/path extraction
(PyTorch port of ``ops/parse_uri.py``).

Parity target: the reference's ``parse_uri.cu`` (validate_uri at
``parse_uri.cu:535``, chunk validators ``:153-493``, query-param narrowing
``find_query_part`` ``:495``) behind ``ParseURI.java:36-98``.  The reference
re-implements ``java.net.URI``'s accept/reject behavior: a URI is validated
*completely* (scheme, fragment, authority incl. IPv4/IPv6/domain hosts, query,
path, escapes, UTF-8) and a fatally-invalid row nulls every chunk, while some
failures (e.g. a bad host) null only that chunk.

Design notes (vs the reference's one-thread-per-row SIMT kernels):

- All character-class validation (``validate_chunk`` + the ``%XX`` escape and
  UTF-8 rules of ``skip_and_validate_special``, ``parse_uri.cu:92-151``) is
  done with *shift-based elementwise masks* over the padded ``[rows, bytes]``
  matrix of each length bucket, no sequential pass at all.  This relies on a
  position-independence property: in any span that the sequential scanner
  accepts, every ``%`` begins an escape (hex chars are never ``%``), and in
  any span it rejects, the first offending position is flagged by the local
  rule too, so "each ``%`` must be followed by two in-span hex bytes" is
  exactly equivalent.  Likewise UTF-8 continuation checks are static shifts
  of the lead-byte mask.
- The three host grammars (IPv4 dotted-quad, registry domain name, IPv6, all
  sequential state machines in the reference, ``:165-345``) run as ONE fused
  lockstep loop across the byte axis with small per-row state vectors, over
  the columns that hold some row's host.  The step is a fixed-shape function
  of the state tensors and a step index held on the device, so on the card
  it is captured once per bucket as a CUDA graph and replayed per column; on
  the CPU it is a plain loop.
- Rows are parsed in blocks of at most ``_BLOCK_ELEMS`` padded bytes, which
  bounds the working set of the ``[rows, bytes]`` masks.
- Bug-compat quirks are preserved deliberately: ``validate_port`` accepts any
  byte (the ``c < '0' && c > '9'`` predicate at ``parse_uri.cu:448`` is never
  true); 'G'-'Z' count as hex digits inside IPv6 groups (``:251``); the
  ``amp == 0`` authority path leaves host offsets relative to the unadvanced
  authority (``:686,:707``); on an empty remainder the valid-bit mask is
  overwritten to just PATH-if-schemeless (``:610``).
- One *resolved* (not preserved) reference quirk: ``has_auth`` probes the byte
  after ``//`` via ``_at``, which reads past-the-end positions as a zero byte
  (one zero column padded after the bucket's bytes; the JAX package clips the
  index to the bucket's last column instead, which differs only for a row
  that fills its bucket and ends in ``scheme:/``).
  The reference reads ``str[1]`` unconditionally (``parse_uri.cu:650``), an
  out-of-bounds read for a 1-byte remainder like ``"http:/"`` — defined
  behavior here (zero byte, no authority) vs memory-dependent UB there.
"""


from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar.buckets import padded_buckets, strings_from_buckets
from spark_rapids_jni_tpu_torch.columnar.column import StringColumn, strings_column

__all__ = [
    "parse_uri_protocol",
    "parse_uri_host",
    "parse_uri_query",
    "parse_uri_query_literal",
    "parse_uri_query_column",
    "parse_uri_path",
]

# Chunk selectors (mirror URI_chunks, parse_uri.cu:58-68).
_PROTOCOL, _HOST, _QUERY, _PATH = 0, 1, 2, 3

# Host validation outcomes (chunk_validity, parse_uri.cu:70).
_H_VALID, _H_INVALID, _H_FATAL = 0, 1, 2

# padded bytes of one parsed block of rows (bounds the [rows, bytes] masks)
_BLOCK_ELEMS = 1 << 26

_I32, _I64 = torch.int32, torch.int64


def _build_luts():
    hexd = np.zeros(256, np.bool_)
    for c in b"0123456789abcdefABCDEF":
        hexd[c] = True
    alpha = np.zeros(256, np.bool_)
    alpha[ord("a"):ord("z") + 1] = True
    alpha[ord("A"):ord("Z") + 1] = True
    digit = np.zeros(256, np.bool_)
    digit[ord("0"):ord("9") + 1] = True
    alnum = alpha | digit

    def from_ranges(singles=b"", ranges=(), minus=b""):
        t = np.zeros(256, np.bool_)
        for c in singles:
            t[c] = True
        for lo, hi in ranges:
            t[lo:hi + 1] = True
        for c in minus:
            t[c] = False
        return t

    # validate_query (parse_uri.cu:399-411)
    query = from_ranges(b'!"$=_~', [(0x26, 0x3B), (0x3F, 0x5D), (0x61, 0x7A)], b"\\")
    # validate_path (parse_uri.cu:453-465)
    path = from_ranges(b"!$=_~", [(0x26, 0x3B), (0x40, 0x5A), (0x61, 0x7A)])
    # validate_opaque / validate_fragment (parse_uri.cu:467-493): identical sets
    opaque = from_ranges(b"!$=_~", [(0x26, 0x3B), (0x3F, 0x5D), (0x61, 0x7A)], b"\\")
    # validate_authority (parse_uri.cu:413-429)
    auth = from_ranges(b"!$=~", [(0x26, 0x3B), (0x40, 0x5F), (0x61, 0x7A)], b"/^\\")
    auth_pct = auth.copy()
    auth_pct[ord("%")] = True
    # validate_userinfo (parse_uri.cu:431-440): anything but brackets
    userinfo = np.ones(256, np.bool_)
    userinfo[ord("[")] = False
    userinfo[ord("]")] = False
    # validate_port (parse_uri.cu:442-451): the predicate can never fail
    port = np.ones(256, np.bool_)
    scheme_rest = alnum.copy()
    for c in b"+-.":
        scheme_rest[c] = True
    return {"hex": hexd, "alpha": alpha, "digit": digit, "alnum": alnum, "query": query,
            "path": path, "opaque": opaque, "fragment": opaque, "auth": auth,
            "auth_pct": auth_pct, "userinfo": userinfo, "port": port,
            "scheme_rest": scheme_rest}


_LUTS_NP = _build_luts()
_LUT_CACHE: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def _luts(dev: torch.device) -> Dict[str, torch.Tensor]:
    """The class tables as bool tensors on ``dev`` (uploaded once per device)."""
    luts = _LUT_CACHE.get(dev)
    if luts is None:
        luts = _LUT_CACHE[dev] = {k: torch.from_numpy(v).to(dev) for k, v in _LUTS_NP.items()}
    return luts


def _first(mask, pos, L):
    """(first position, found) over axis 1; position is L+9 when not found."""
    return torch.where(mask, pos, L + 9).amin(dim=1), mask.any(dim=1)


def _last(mask, pos):
    return torch.where(mask, pos, -1).amax(dim=1), mask.any(dim=1)


def _at(bz, idx):
    """One byte per row of the zero-padded ``bz[n, L+1]`` at ``idx``; an
    index past the row's bytes reads the zero column (callers gate
    validity)."""
    L = bz.shape[1] - 1
    return torch.gather(bz, 1, torch.clamp(idx, 0, L)[:, None].to(_I64))[:, 0]


def _shr(m, k):
    """Shift mask right along the byte axis: out[i] = m[i-k]."""
    out = torch.zeros_like(m)
    if k < m.shape[1]:
        out[:, k:] = m[:, :m.shape[1] - k]
    return out


class _Bytes:
    """One rectangle's bytes and the span-independent parts of the chunk
    validation (escapes' hex pairs, UTF-8 sequences and the class of every
    byte), computed once and shared by every span validated over it."""

    def __init__(self, b, lut_t):
        n, L = b.shape
        self.b, self.lut_t = b, lut_t
        bx = F.pad(b, (0, 4))
        self.bz = bx[:, :L + 1]
        self.pos = torch.arange(L, dtype=_I32, device=b.device)[None, :]
        self.bi = b.to(_I32)
        b1, b2, b3 = bx[:, 1:L + 1], bx[:, 2:L + 2], bx[:, 3:L + 3]
        hex_t = lut_t["hex"]
        self.is_pct = b == ord("%")
        self.hex_pair = hex_t[b1.to(_I32)] & hex_t[b2.to(_I32)]
        # Multi-byte UTF-8 (skip_and_validate_special, parse_uri.cu:108-123):
        # lead bytes >= 0xC0 consume their continuations; continuations must
        # be 10xxxxxx and the packed codepoint bytes must not be unicode
        # whitespace.
        nb = 1 + (b >= 0xC0).to(_I32) + (b >= 0xE0).to(_I32) + (b >= 0xF0).to(_I32)
        cont1 = (b1 & 0xC0) == 0x80
        cont2 = (b2 & 0xC0) == 0x80
        cont3 = (b3 & 0xC0) == 0x80
        utf8_ok = torch.where(nb == 2, cont1, torch.where(nb == 3, cont1 & cont2,
                                                          cont1 & cont2 & cont3))
        p2 = (self.bi << 8) | b1.to(_I32)
        p3 = (p2 << 8) | b2.to(_I32)
        forb2 = (p2 >= 0xC280) & (p2 <= 0xC2A0)
        forb3 = (((p3 >= 0xE28080) & (p3 <= 0xE2808A)) | (p3 == 0xE19A80) | (p3 == 0xE280AF)
                 | (p3 == 0xE280A8) | (p3 == 0xE2819F) | (p3 == 0xE38080))
        self.multi = nb > 1
        self.lead_bad = ~utf8_ok | ((nb == 2) & forb2) | ((nb == 3) & forb3)
        self.nb2, self.nb3, self.nb4 = nb >= 2, nb >= 3, nb >= 4
        self._in_class: Dict[str, torch.Tensor] = {}

    def in_class(self, name):
        got = self._in_class.get(name)
        if got is None:
            got = self._in_class[name] = self.lut_t[name][self.bi]
        return got


def _validate_span(x, s, e, lut, raw_pct=None):
    """Vectorized validate_chunk (parse_uri.cu:133-151) over per-row spans
    ``[s, e)`` of the rectangle ``x`` against the byte class ``lut``.

    ``raw_pct`` (bool[n] or None) mirrors allow_invalid_escapes: where True,
    '%' is an ordinary character checked against the LUT instead of starting a
    mandatory %XX escape.
    """
    pos = x.pos
    in_span = (pos >= s[:, None]) & (pos < e[:, None])
    if raw_pct is None:
        esc_start = in_span & x.is_pct
    else:
        esc_start = in_span & x.is_pct & ~raw_pct[:, None]
    esc_ok = (pos + 2 < e[:, None]) & x.hex_pair  # pos + 1 < e follows
    esc_viol = esc_start & ~esc_ok
    esc_hex = _shr(esc_start, 1) | _shr(esc_start, 2)
    lead = in_span & x.multi & ~esc_hex
    lead_viol = lead & x.lead_bad
    cover = _shr(lead & x.nb2, 1) | _shr(lead & x.nb3, 2) | _shr(lead & x.nb4, 3)
    plain_viol = in_span & ~esc_start & ~esc_hex & ~lead & ~cover & ~x.in_class(lut)
    return ~(esc_viol | lead_viol | plain_viol).any(dim=1)


# the host machines' per-row state: (name, dtype, initial value)
_HOST_STATE = (
    # ipv4 (parse_uri.cu:269-304)
    ("a4", _I32, 0), ("s4", _I32, 0), ("d4", _I32, 0), ("ok4", torch.bool, True),
    # domain (parse_uri.cu:306-345)
    ("dh", torch.bool, False), ("dp", torch.bool, False), ("dn", torch.bool, False),
    ("dc", _I32, 0), ("okd", torch.bool, True),
    # ipv6 (parse_uri.cu:165-267)
    ("v6_dc", torch.bool, False), ("v6_ob", _I32, 0), ("v6_cb", _I32, 0), ("v6_pr", _I32, 0),
    ("v6_co", _I32, 0), ("v6_pc", _I32, 0), ("v6_prev", torch.uint8, 0), ("v6_a", _I32, 0),
    ("v6_ac", _I32, 0), ("v6_hx", torch.bool, False), ("ok6", torch.bool, True),
)


class _HostMachines:
    """The fused IPv4 / domain / IPv6 validators over ``n`` rows' host spans
    ``[hs, he)``, one byte column per step.  The column index lives on the
    device (``t``), so every step runs the same kernels: on the card the
    step is captured once as a CUDA graph and replayed."""

    def __init__(self, b, hs, he, t0: int, lut_t):
        n = b.shape[0]
        dev = b.device
        self.bT = b.t().contiguous()  # [L, n]: one step reads one contiguous row
        self.hs, self.he = hs, he
        self.digit, self.alnum = lut_t["digit"], lut_t["alnum"]
        self.st = {k: torch.full((n,), v, dtype=dt, device=dev) for k, dt, v in _HOST_STATE}
        self.t = torch.full((1,), t0, dtype=_I64, device=dev)

    def step(self):
        st, t = self.st, self.t
        c = self.bT.index_select(0, t)[0]
        tt = t.to(_I32)
        ins = (tt >= self.hs) & (tt < self.he)
        fst = tt == self.hs
        lst = tt == self.he - 1
        ci = c.to(_I32)
        dig = self.digit[ci]
        dv = ci - ord("0")

        # ---- IPv4: digits and interior dots; every prefix value <= 255.
        dot = c == ord(".")
        ok4 = st["ok4"] & (dig | (dot & ~fst))
        ok4 = torch.where(dot, ok4 & (st["s4"] > 0), ok4)
        a4n = torch.clamp(st["a4"] * 10 + dv, max=1000)
        ok4 = torch.where(dig, ok4 & (a4n <= 255), ok4)
        a4 = torch.where(dot, 0, torch.where(dig, a4n, st["a4"]))
        s4 = torch.where(dot, 0, torch.where(dig, st["s4"] + 1, st["s4"]))
        d4 = st["d4"] + dot.to(_I32)

        # ---- Domain name: alnum/-/.; '-' not at edges or beside '.'; '.' not
        # doubled/leading; final label must not start with a digit.
        an = self.alnum[ci]
        hy = c == ord("-")
        pd = c == ord(".")
        okd = st["okd"] & (an | hy | pd)
        dn = st["dp"] & dig
        okd = torch.where(hy, okd & ~st["dp"] & ~fst & ~lst, okd)
        okd = torch.where(pd, okd & ~st["dh"] & ~st["dp"] & (st["dc"] > 0), okd)
        dh = hy
        dp = pd
        dcnt = torch.where(hy | pd, torch.where(pd, 0, st["dc"]), st["dc"] + 1)
        dcnt = torch.where(hy, st["dc"], dcnt)

        # ---- IPv6 (with bracket/zone%/embedded-IPv4 bookkeeping).
        is_ob = c == ord("[")
        is_cb = c == ord("]")
        is_co = c == ord(":")
        is_pd = c == ord(".")
        is_pc = c == ord("%")
        other = ~(is_ob | is_cb | is_co | is_pd | is_pc)
        ok6 = st["ok6"]
        ob = st["v6_ob"] + is_ob.to(_I32)
        cb = st["v6_cb"] + is_cb.to(_I32)
        ok6 = torch.where(is_ob, ok6 & (ob <= 1), ok6)
        seg_bad = st["v6_hx"] | (st["v6_a"] > 255)
        ok6 = torch.where(is_cb, ok6 & (cb <= 1) & ~((st["v6_pr"] > 0) & seg_bad), ok6)
        dbl = st["v6_prev"] == ord(":")
        co = st["v6_co"] + is_co.to(_I32)
        ok6 = torch.where(
            is_co,
            ok6 & ~(dbl & st["v6_dc"]) & ~((co > 8) | ((co == 8) & ~(st["v6_dc"] | dbl)))
            & ~((st["v6_pr"] > 0) | (st["v6_pc"] > 0)),
            ok6)
        v6_dc = st["v6_dc"] | (is_co & dbl)
        pr = st["v6_pr"] + is_pd.to(_I32)
        ok6 = torch.where(
            is_pd,
            ok6 & (st["v6_pc"] == 0) & (pr <= 3) & ~st["v6_hx"] & (st["v6_a"] <= 255)
            & ((st["v6_co"] == 6) | st["v6_dc"]) & (st["v6_co"] < 8),
            ok6)
        pc = st["v6_pc"] + is_pc.to(_I32)
        ok6 = torch.where(is_pc, ok6 & (pc <= 1) & ~((st["v6_pr"] > 0) & seg_bad), ok6)
        in_group = other & (st["v6_pc"] == 0)
        lower = (c >= ord("a")) & (c <= ord("f"))
        upper = (c >= ord("A")) & (c <= ord("Z"))  # bug-compat: G-Z "hex"
        ok6 = torch.where(in_group, ok6 & (st["v6_ac"] <= 3) & (lower | upper | dig), ok6)
        add = torch.where(lower, 10 + ci - ord("a"), torch.where(upper, 10 + ci - ord("A"), dv))
        a6n = torch.clamp(st["v6_a"] * 10 + torch.where(lower | upper | dig, add, 0), max=99999)
        reset6 = is_co | is_pd | is_pc
        v6_a = torch.where(reset6, 0, torch.where(in_group, a6n, st["v6_a"]))
        v6_ac = torch.where(reset6, 0, torch.where(in_group, st["v6_ac"] + 1, st["v6_ac"]))
        v6_hx = torch.where(reset6, False, st["v6_hx"] | (in_group & (lower | upper)))

        new = dict(a4=a4, s4=s4, d4=d4, ok4=ok4, dh=dh, dp=dp, dn=dn, dc=dcnt, okd=okd,
                   v6_dc=v6_dc, v6_ob=ob, v6_cb=cb, v6_pr=pr, v6_co=co, v6_pc=pc,
                   v6_prev=c, v6_a=v6_a, v6_ac=v6_ac, v6_hx=v6_hx, ok6=ok6)
        # rows whose host span does not hold this column keep their state
        for k, v in new.items():
            st[k].copy_(torch.where(ins, v.to(st[k].dtype), st[k]))
        self.t += 1

    def capture(self):
        """One step as a CUDA graph over the state tensors (updated in place)."""
        graph = torch.cuda.CUDAGraph()
        with _device.graph_capture(graph):
            self.step()
        return graph


def _host_machines(b, hs, he, lut_t):
    """One fused lockstep walk over the byte columns running the IPv4
    dotted-quad, domain-name, and IPv6 validators (parse_uri.cu:165-345) for
    every row's host span simultaneously.  Returns (ipv4_ok, domain_ok,
    ipv6_ok)."""
    n, L = b.shape
    live = he > hs
    t0, t1 = (torch.stack([torch.where(live, hs, L).amin(), torch.where(live, he, 0).amax()])
              .tolist() if n else (0, 0))
    t0, t1 = max(int(t0), 0), min(int(t1), L)
    m = _HostMachines(b, hs, he, t0, lut_t)
    graph = None
    for t in range(t0, t1):
        if b.device.type == "cuda" and t > t0:
            if graph is None:
                graph = m.capture()
            graph.replay()
        else:
            m.step()
    del graph
    st = m.st
    ipv4_ok = st["ok4"] & (st["s4"] > 0) & (st["d4"] == 3)
    domain_ok = st["okd"] & ~st["dn"]
    ipv6_ok = st["ok6"] & ((he - hs) >= 2)
    return ipv4_ok, domain_ok, ipv6_ok


def _validate_host(x, hs, he):
    """validate_host (parse_uri.cu:347-397) -> 0 VALID / 1 INVALID / 2 FATAL."""
    b, bz, pos, lut_t = x.b, x.bz, x.pos, x.lut_t
    n, L = b.shape
    in_span = (pos >= hs[:, None]) & (pos < he[:, None])
    ipv4_ok, domain_ok, ipv6_ok = _host_machines(b, hs, he, lut_t)

    first_b = _at(bz, hs)
    last_b = _at(bz, he - 1)
    starts_br = (first_b == ord("[")) & (he > hs)
    bracket_any = (in_span & ((b == ord("[")) | (b == ord("]")))).any(dim=1)
    lp, lp_f = _last(in_span & (b == ord(".")), pos.expand(n, L))
    after = _at(bz, lp + 1)
    domain_route = ~lp_f | (lp == he - 1) | ~lut_t["digit"][after.to(_I32)]

    bracket_state = torch.where((last_b == ord("]")) & ipv6_ok, _H_VALID, _H_FATAL)
    plain_state = torch.where(
        bracket_any, _H_FATAL,
        torch.where(domain_route, torch.where(domain_ok, _H_VALID, _H_INVALID),
                    torch.where(ipv4_ok, _H_VALID, _H_INVALID)))
    return torch.where(starts_br, bracket_state, plain_state)


def _parse(padded, lens, valid_in, want, with_needle, n_padded, n_lens, n_valid):
    """Vectorized validate_uri (parse_uri.cu:535-746) + chunk selection.
    Returns ``(gathered[n, L] uint8, out_len[n], out_valid[n])``."""
    n, L = padded.shape
    dev = padded.device
    lut_t = _luts(dev)
    x = _Bytes(padded, lut_t)
    b, bz, pos = padded, x.bz, x.pos
    lens = lens.to(_I32)
    in_str = pos < lens[:, None]
    posb = pos.expand(n, L)

    col_p, col_f = _first(in_str & (b == ord(":")), posb, L)
    slash_p, slash_f = _first(in_str & (b == ord("/")), posb, L)
    hash_p, hash_f = _first(in_str & (b == ord("#")), posb, L)
    q_p, q_f = _first(in_str & (b == ord("?")), posb, L)

    # Fragment: everything after '#'; invalid fragment kills the row
    # (parse_uri.cu:569-582).
    E = torch.where(hash_f, hash_p, lens)
    frag_ok = _validate_span(x, hash_p + 1, lens, "fragment")
    row_pre = torch.where(hash_f, frag_ok, True)
    col_f = col_f & (~hash_f | (col_p < hash_p))
    slash_f = slash_f & (~hash_f | (slash_p < hash_p))
    q_f = q_f & (~hash_f | (q_p < hash_p))

    # Scheme (parse_uri.cu:584-603).
    has_scheme = col_f & (~slash_f | (col_p < slash_p))
    first_alpha = lut_t["alpha"][b[:, 0].to(_I32)]
    rest_bad = ((pos >= 1) & (pos < col_p[:, None]) & in_str
                & ~x.in_class("scheme_rest")).any(dim=1)
    scheme_ok = (col_p > 0) & first_alpha & ~rest_bad
    row_pre = row_pre & (~has_scheme | scheme_ok)
    proto_bit = has_scheme & scheme_ok
    rs = torch.where(has_scheme, col_p + 1, 0)
    empty_rest = (E - rs) <= 0

    # Hierarchical vs opaque (parse_uri.cu:614-616).
    hier = (_at(bz, rs) == ord("/")) | (rs == 0)

    # Query (parse_uri.cu:619-647).
    has_q = hier & q_f & (q_p >= rs)
    qs = torch.where(has_q, q_p + 1, 0)
    qe = torch.where(has_q, E, 0)
    query_ok = _validate_span(x, qs, qe, "query")
    row_post = torch.where(has_q, query_ok, True)
    query_bit = has_q & query_ok

    PE = torch.where(has_q, q_p, E)

    # Authority (parse_uri.cu:650-725).
    has_auth = hier & (_at(bz, rs) == ord("/")) & (_at(bz, rs + 1) == ord("/"))
    a_s = rs + 2
    ns_p, ns_f = _first((b == ord("/")) & (pos >= a_s[:, None]) & (pos < PE[:, None]), posb, L)
    a_e = torch.where(ns_f, ns_p, torch.where(has_q, q_p, E))
    auth_nonempty = has_auth & (a_e > a_s)
    ipv6_escapes = auth_nonempty & ((a_e - a_s) > 2) & (_at(bz, a_s) == ord("["))
    auth_lut_ok = _validate_span(x, a_s, a_e, "auth")
    auth_lut_ok_pct = _validate_span(x, a_s, a_e, "auth_pct",
                                     raw_pct=torch.ones((n,), dtype=torch.bool, device=dev))
    auth_ok = torch.where(ipv6_escapes, auth_lut_ok_pct, auth_lut_ok)
    row_post = row_post & (~auth_nonempty | auth_ok)
    auth_bit = auth_nonempty & auth_ok

    in_auth = (pos >= a_s[:, None]) & (pos < a_e[:, None])
    amp_p, amp_f = _first(in_auth & (b == ord("@")), posb, L)
    bound = torch.where(amp_f, amp_p, a_s - 1)
    lc_p, lc_f = _last(in_auth & (b == ord(":")) & (pos > bound[:, None]), posb)
    cb_p, cb_f = _first(in_auth & (b == ord("]")) & (pos > bound[:, None]), posb, L)
    amp_rel = amp_p - a_s
    has_ui = auth_bit & amp_f & (amp_rel > 0)
    ui_ok = _validate_span(x, a_s, amp_p, "userinfo")
    row_post = row_post & (~has_ui | ui_ok)
    hs = torch.where(has_ui, amp_p + 1, a_s)
    # Offsets adjust relative to the '@' only when amp > 0 (parse_uri.cu:686-688)
    adj = amp_f & (amp_rel > 0)
    lc_rel = torch.where(lc_f, torch.where(adj, lc_p - amp_p - 1, lc_p - a_s), -1)
    cb_rel = torch.where(cb_f, torch.where(adj, cb_p - amp_p, cb_p - a_s), -1)
    has_port = auth_bit & (lc_rel > 0) & (lc_rel > cb_rel)
    port_ok = _validate_span(x, hs + lc_rel + 1, a_e, "port")
    row_post = row_post & (~has_port | port_ok)
    host_s = hs
    host_e = torch.where(has_port, hs + lc_rel, a_e)
    host_state = _validate_host(x, host_s, host_e)
    row_post = row_post & (~auth_bit | (host_state != _H_FATAL))
    host_bit = auth_bit & (host_state == _H_VALID)

    # Path (parse_uri.cu:661,:726-735): with authority, only from the slash
    # after it (empty, but present, otherwise); without, the whole remainder.
    path_s = torch.where(has_auth, torch.where(ns_f, ns_p, 0), rs)
    path_e = torch.where(has_auth, torch.where(ns_f, PE, 0), PE)
    path_ok = _validate_span(x, path_s, path_e, "path")
    row_post = row_post & (~hier | path_ok)
    path_bit = hier & path_ok

    # Opaque (parse_uri.cu:736-743).
    opq_ok = _validate_span(x, rs, E, "opaque")
    row_post = row_post & (hier | opq_ok)

    # Query-param narrowing (find_query_part, parse_uri.cu:495-533).
    if with_needle:
        NL = n_padded.shape[1]
        nl = n_lens.to(_I32)
        B = F.pad(b, (0, NL + 1))
        m = torch.ones((n, L), dtype=torch.bool, device=dev)
        for j in range(NL):
            m &= (j >= nl[:, None]) | (B[:, j:j + L] == n_padded[:, j:j + 1])
        eq_at = torch.gather(B, 1, (pos + nl[:, None]).to(_I64))
        m &= eq_at == ord("=")
        prev_amp = _shr(b == ord("&"), 1)
        cand = (posb == qs[:, None]) | ((pos > qs[:, None]) & (pos < qe[:, None]) & prev_amp)
        cand = cand & ((pos + nl[:, None]) < qe[:, None])
        hit_p, hit_f = _first(cand & m, posb, L)
        v_s = hit_p + nl + 1
        amp2_p, amp2_f = _first((b == ord("&")) & (pos >= v_s[:, None]) & (pos < qe[:, None]),
                                posb, L)
        v_e = torch.where(amp2_f, amp2_p, qe)
        matched = hit_f & n_valid
        query_bit = query_bit & matched
        qs = torch.where(matched, v_s, qs)
        qe = torch.where(matched, v_e, qe)

    row_ok = valid_in & row_pre & (empty_rest | row_post)

    if want == _PROTOCOL:
        s, e, bit = torch.zeros_like(rs), col_p, proto_bit
    elif want == _HOST:
        s, e, bit = host_s, host_e, host_bit
    elif want == _QUERY:
        s, e, bit = qs, qe, query_bit
    else:
        s, e, bit = path_s, path_e, path_bit

    # Empty remainder: the valid mask collapses to PATH-iff-no-scheme
    # (parse_uri.cu:606-612), even PROTOCOL/FRAGMENT bits are dropped.
    if want == _PATH:
        bit = torch.where(empty_rest, ~has_scheme, bit)
        s = torch.where(empty_rest, 0, s)
        e = torch.where(empty_rest, 0, e)
    else:
        bit = bit & ~empty_rest

    out_valid = row_ok & bit
    out_len = torch.clamp(e - s, min=0)
    out_len = torch.where(out_valid, out_len, 0)
    # bytes past out_len are never read: clamp their index into bounds
    idx = torch.clamp(s[:, None] + pos, 0, L).to(_I64)
    gathered = torch.gather(bz, 1, idx)
    return gathered, out_len, out_valid


def _run(input: StringColumn, want: int, needle=None) -> StringColumn:
    n = input.size
    dev = input.device
    if n == 0:
        return StringColumn(torch.zeros((0,), dtype=torch.uint8, device=dev),
                            torch.zeros((1,), dtype=_I32, device=dev), None)
    valid_in = input.is_valid()
    if needle is None:
        np_ = torch.zeros((n, 1), dtype=torch.uint8, device=dev)
        nl_ = torch.zeros((n,), dtype=_I32, device=dev)
        nv_ = torch.ones((n,), dtype=torch.bool, device=dev)
        with_needle = False
    else:
        if needle.size not in (1, n):
            # The reference JNI layer only ever passes a scalar key or a
            # same-size column (ParseURI.java:70-93)
            raise ValueError(f"query key column must have 1 or {n} rows, got {needle.size}")
        np_, nl_ = needle.padded()
        nv_ = needle.is_valid()
        if needle.size == 1 and n != 1:
            np_ = np_.expand(n, np_.shape[1])
            nl_ = nl_.expand(n)
            nv_ = nv_.expand(n)
        with_needle = True

    # Length-bucketed sweep: each URI length class parses over its own dense
    # rectangle (one long URL doesn't pad the whole column), in row blocks.
    results = []
    out_valid_full = torch.zeros((n,), dtype=torch.bool, device=dev)
    for bk in padded_buckets(input):
        step = max(1, _BLOCK_ELEMS // bk.width)
        for r0 in range(0, bk.rows.numel(), step):
            rows = bk.rows[r0:r0 + step]
            gathered, out_len, out_valid = _parse(
                bk.bytes[r0:r0 + step], bk.lengths[r0:r0 + step], valid_in[rows], want,
                with_needle, np_[rows], nl_[rows], nv_[rows])
            results.append((rows, gathered, out_len))
            out_valid_full[rows] = out_valid
    return strings_from_buckets(n, results, out_valid_full)


def parse_uri_protocol(input: StringColumn) -> StringColumn:
    """Spark ``parse_url(url, 'PROTOCOL')`` (ParseURI.java:36)."""
    return _run(input, _PROTOCOL)


def parse_uri_host(input: StringColumn) -> StringColumn:
    """Spark ``parse_url(url, 'HOST')`` (ParseURI.java:47)."""
    return _run(input, _HOST)


def parse_uri_query(input: StringColumn) -> StringColumn:
    """Spark ``parse_url(url, 'QUERY')`` (ParseURI.java:58)."""
    return _run(input, _QUERY)


def parse_uri_query_literal(input: StringColumn, literal: str) -> StringColumn:
    """Spark ``parse_url(url, 'QUERY', key)`` with a literal key
    (ParseURI.java:70)."""
    return _run(input, _QUERY, needle=strings_column([literal], device=input.device))


def parse_uri_query_column(input: StringColumn, keys: StringColumn) -> StringColumn:
    """Spark ``parse_url(url, 'QUERY', key)`` with a per-row key column
    (ParseURI.java:82)."""
    return _run(input, _QUERY, needle=keys)


def parse_uri_path(input: StringColumn) -> StringColumn:
    """Spark ``parse_url(url, 'PATH')`` (ParseURI.java:94)."""
    return _run(input, _PATH)
