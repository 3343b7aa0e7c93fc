"""The JSON path machine in torch: the core of get_json_object's device arm
(PyTorch port of ``ops/json_scan.py``).

A device translation of the host ``_Machine`` in ops/get_json_object.py: the
explicit-stack form of evaluate_path (get_json_object.cu:360-394) with every
row advancing one token (or one frame return) per lockstep step over ``[R]``
and ``[R, F]`` state, frame and generator stacks read with ``torch.gather``
at the stack pointer and written with ``scatter_``.

All paths of a call run in ONE machine: row ``r`` of the machine is path
``r // n`` over bucket row ``r % n``, so P paths cost the kernel launches of
one (each step is ~250 small kernels; on the card a step is captured once
as a CUDA graph and replayed).  Each row's path program (instruction types,
index arguments and name-table slots) is read through its path id.

The JAX package scans all ``2T + 40`` steps.  This machine computes the same
rows with three schedule changes that leave every output unchanged:

- it stops once no row is live (checked every ``_CHECK_EVERY`` steps; a step
  with no live row changes nothing);
- once at most three quarters of its rows are live it gathers its state
  down to them, as the host machine's ``json_compact`` does (at a half),
  banking the finished rows;
- segments are written compacted: each row appends its non-empty segments
  at its own count ``nseg``, and a case-6 conditional open is resolved at its
  close by writing the resolved constant at the position the open took
  (the host machine's patches), so no per-step ``[n, 2, 2]`` record and no
  ``[n, steps]`` resolution tables are kept.  The frame stack and the
  segment table grow as the rows need (never past ``F``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.ops import json_tokenizer as jt
from spark_rapids_jni_tpu_torch.ops.get_json_object import (
    INDEX,
    NAMED,
    WILDCARD,
    _C_CLOSE_ARR,
    _C_COLON,
    _C_COMMA,
    _C_COMMA_OPEN,
    _C_EMPTY,
    _C_OPEN_ARR,
    _F_CASE2,
    _F_CASE4,
    _F_CASE5,
    _F_CASE6,
    _F_CASE7,
    _F_CASE8,
    _F_COPY,
    _FLATTEN,
    _P_END,
    _QUOTED,
    _RAW,
    _SCALARS,
    _SEG_COND_OPEN,
    _SEG_CONST,
    _SEG_ESC_TOK,
    _SEG_NONE,
    _SEG_RAW_TOK,
    _SUB_DRAIN,
    _SUB_ENTERING,
    _SUB_NONE,
    _SUB_WAITING,
)

__all__ = ["run_scan", "SEG_SHIFT"]

_I8 = torch.int8
_I32 = torch.int32
_I64 = torch.int64
_BOOL = torch.bool

# packed segment: type | arg << SEG_SHIFT (int32); 0 is _SEG_NONE
SEG_SHIFT = 3

_CHECK_EVERY = 8  # steps between live-row checks (one host sync each)
_COMPACT_MIN_ROWS = 4096  # never compact machines smaller than this
_COMPACT_LIVE = 0.75  # compact once at most this share of the rows is live


def _isin(x, values):
    out = x == values[0]
    for v in values[1:]:
        out = out | (x == v)
    return out


def _kind_table(values, device):
    """bool[16] lookup: token kind -> kind in ``values``."""
    t = torch.zeros((16,), dtype=_BOOL)
    t[list(values)] = True
    return t.to(device)


def _pack(t, a):
    return torch.where(t != _SEG_NONE, t | (a << SEG_SHIFT), 0).to(_I32)


class _Scan:
    """Lockstep machine state over the live rows (see the module doc).

    Column 0 of every frame and generator stack and of the segment table is
    a write sink: a masked write scatters each row either to its target or
    to its sink, so no read-modify-write is needed, and all writes of one
    mask share one index.
    """

    _ROW_FIELDS = ("tcur", "err", "done", "dirty_root", "ret_valid", "ret_dirty", "fp",
                   "gp", "entered_root", "nseg", "rowmap", "kbase", "pbase", "nmbase",
                   "ntok_r", "f_case", "f_path", "f_style", "f_dirty", "f_sub", "f_aux",
                   "f_flag", "g_depth", "g_empty", "seg")
    _FRAMES = ("f_case", "f_path", "f_style", "f_dirty", "f_sub", "f_aux", "f_flag")

    def __init__(self, kind, match, ntok, ok, nm_tab, ptype, parg, slot, P: int,
                 F: int, G: int):
        n, T = kind.shape
        dev = kind.device
        R = P * n
        self.n, self.T, self.F, self.G, self.R0 = n, T, F, G, R
        self.P1 = ptype.shape[1]
        self.dev = dev
        self.kind_f = kind.to(_I32).reshape(-1)
        self.match_f = match.to(_I32).reshape(-1)
        self.nm_f = nm_tab.reshape(-1)
        self.ptype_f = ptype.reshape(-1)
        self.parg_f = parg.reshape(-1)
        self.slot_f = slot.reshape(-1)
        # kind -> class lookups (one index kernel instead of a compare chain)
        self.valend_tab = _kind_table(_SCALARS + (jt.END_OBJECT, jt.END_ARRAY), dev)
        self.badk_tab = _kind_table((jt.FIELD_NAME, jt.END_OBJECT, jt.END_ARRAY, jt.ERRORTOK,
                                     jt.PAD), dev)
        r = torch.arange(R, dtype=_I64, device=dev)
        q = r % n
        self.rowmap = r
        self.kbase = q * T
        self.pbase = (r // n) * self.P1
        self.nmbase = q * T
        self.ntok_r = ntok.to(_I32)[q]
        self.tcur = torch.zeros((R,), dtype=_I32, device=dev)
        self.err = ~ok[q]
        self.done = torch.zeros((R,), dtype=_BOOL, device=dev)
        self.dirty_root = torch.zeros((R,), dtype=_I32, device=dev)
        self.ret_valid = torch.zeros((R,), dtype=_BOOL, device=dev)
        self.ret_dirty = torch.zeros((R,), dtype=_I32, device=dev)
        self.fp = torch.full((R,), -1, dtype=_I32, device=dev)
        self.gp = torch.zeros((R,), dtype=_I32, device=dev)
        self.entered_root = torch.zeros((R,), dtype=_BOOL, device=dev)
        self.nseg = torch.ones((R,), dtype=_I32, device=dev)  # next free column
        w = min(F, _CHECK_EVERY + 8) + 1
        z = lambda w, dt: torch.zeros((R, w), dtype=dt, device=dev)  # noqa: E731
        self.f_case, self.f_path, self.f_style = z(w, _I8), z(w, _I32), z(w, _I8)
        self.f_dirty, self.f_sub, self.f_aux = z(w, _I32), z(w, _I8), z(w, _I32)
        self.f_flag = z(w, _BOOL)
        self.g_depth = z(G + 1, _I32)
        self.g_empty = torch.ones((R, G + 1), dtype=_BOOL, device=dev)
        self.seg = z(4 * _CHECK_EVERY, _I32)
        # banked results of finished rows (entry row space)
        self.err_out = torch.zeros((R,), dtype=_BOOL, device=dev)
        self.done_out = torch.zeros((R,), dtype=_BOOL, device=dev)
        self.dirty_out = torch.zeros((R,), dtype=_I32, device=dev)
        self.banked: List[tuple] = []  # (entry rows, seg rows)
        self._fpi = self._gpi = None

    # -- stack helpers ------------------------------------------------------
    def _set_fp(self, v):
        self.fp = v
        self._fpi = None

    def _set_gp(self, v):
        self.gp = v
        self._gpi = None

    def fpi(self):
        """The top frame's column ([R, 1]; fp -1 reads frame 0)."""
        if self._fpi is None:
            self._fpi = (torch.clamp(self.fp, 0, self.f_case.shape[1] - 2) + 1).to(_I64)[:, None]
        return self._fpi

    def gpi(self):
        if self._gpi is None:
            self._gpi = (torch.clamp(self.gp, 0, self.G - 1) + 1).to(_I64)[:, None]
        return self._gpi

    @staticmethod
    def _at(col, mask):
        """Write columns: ``col`` where ``mask``, else the sink (column 0)."""
        return torch.where(mask[:, None], col, 0)

    @staticmethod
    def _put(arr, idx, val):
        if isinstance(val, torch.Tensor):
            arr.scatter_(1, idx, val.to(arr.dtype)[:, None])
        else:
            arr.scatter_(1, idx, val)

    def top(self, arr):
        return torch.gather(arr, 1, self.fpi())[:, 0]

    def gtop(self, arr):
        return torch.gather(arr, 1, self.gpi())[:, 0]

    def kind_at(self, idx):
        return self.kind_f[self.kbase + torch.clamp(idx, 0, self.T - 1)]

    def match_at(self, idx):
        return self.match_f[self.kbase + torch.clamp(idx, 0, self.T - 1)]

    # -- capacity, compaction -------------------------------------------------
    def _grow(self, max_fp: int, max_nseg: int):
        fa = self.f_case.shape[1] - 1
        need = max_fp + _CHECK_EVERY + 2
        if need > fa and fa < self.F:
            w = min(self.F, max(2 * fa, need))
            for f in self._FRAMES:
                a = getattr(self, f)
                setattr(self, f, torch.cat([a, a.new_zeros((a.shape[0], w - fa))], 1))
            self._fpi = None
        cap = self.seg.shape[1]
        need = max_nseg + 2 * _CHECK_EVERY + 2
        if need > cap:
            w = max(2 * cap, need)
            self.seg = torch.cat([self.seg, self.seg.new_zeros((self.seg.shape[0], w - cap))], 1)

    def _bank(self, sel, width: int):
        tgt = self.rowmap[sel]
        self.err_out[tgt] = self.err[sel]
        self.done_out[tgt] = self.done[sel]
        self.dirty_out[tgt] = self.dirty_root[sel]
        self.banked.append((tgt, self.seg[sel, :max(width, 1)]))

    def _compact(self, keep, width: int):
        self._bank(torch.nonzero(~keep).flatten(), width)
        sel = torch.nonzero(keep).flatten()
        for f in self._ROW_FIELDS:
            setattr(self, f, getattr(self, f)[sel])
        self._fpi = self._gpi = None

    # -- the machine ----------------------------------------------------------
    _STEP_OUT = ("tcur", "err", "done", "dirty_root", "ret_valid", "ret_dirty", "fp", "gp",
                 "entered_root", "nseg")

    def _capture(self):
        """One step captured as a CUDA graph over the current state tensors:
        a replay reads them and writes the step's results back into them."""
        static = {f: getattr(self, f) for f in self._STEP_OUT}
        self._fpi = self._gpi = None
        graph = torch.cuda.CUDAGraph()
        with _device.graph_capture(graph):
            self._step()
            for f, t in static.items():
                t.copy_(getattr(self, f))
                setattr(self, f, t)
        self._fpi = self._gpi = None
        return graph

    def run(self, steps: int) -> int:
        """Step to quiescence or ``steps``; returns the step-cap truncation
        count (rows still live at the cap)."""
        # on the card each step after the first check replays one captured
        # CUDA graph (recaptured when a compaction or growth changes the
        # state's shapes): one launch instead of a few hundred, same kernels
        graphs = self.dev.type == "cuda"
        graph = None
        s = 0
        while s < steps:
            if s % _CHECK_EVERY == 0:
                live = ~(self.done | self.err)
                n_live, max_fp, max_nseg = torch.stack([
                    live.sum(dtype=_I64), self.fp.max().to(_I64),
                    self.nseg.max().to(_I64)]).tolist()
                if n_live == 0:
                    break
                shapes = (self.tcur.shape[0], self.f_case.shape[1], self.seg.shape[1])
                if live.numel() >= _COMPACT_MIN_ROWS and n_live <= _COMPACT_LIVE * live.numel():
                    self._compact(live, max_nseg)
                self._grow(max_fp, max_nseg)
                if shapes != (self.tcur.shape[0], self.f_case.shape[1], self.seg.shape[1]):
                    graph = None
            if graphs and s >= _CHECK_EVERY:  # the first steps run eagerly (warm-up)
                if graph is None:
                    graph = self._capture()
                graph.replay()
            else:
                self._step()
            s += 1
        del graph
        live = ~(self.done | self.err)
        n_trunc = int(live.sum())
        self.err = self.err | live
        self._bank(torch.arange(live.numel(), device=self.dev),
                   int(self.nseg.max()) if live.numel() else 0)
        return n_trunc

    def segments(self):
        """``(err [R0], seg [R0, K])`` in entry row space: ``err`` is the
        row's null verdict (error, unfinished or nothing written) and ``seg``
        its packed segments in order, unresolved conditional opens dropped."""
        K = max([s.shape[1] for _, s in self.banked] + [2])
        seg = torch.zeros((self.R0, K), dtype=_I32, device=self.dev)
        for rows, s in self.banked:
            if rows.numel():
                seg[rows, : s.shape[1]] = s
        seg = seg[:, 1:]  # the sink column
        seg = torch.where((seg & ((1 << SEG_SHIFT) - 1)) == _SEG_COND_OPEN, 0, seg)
        err = self.err_out | ~self.done_out | (self.dirty_out <= 0)
        return err, seg

    def _emit(self, t, a):
        v = _pack(t, a)
        self.seg.scatter_(1, self.nseg.to(_I64)[:, None], v[:, None])
        self.nseg = self.nseg + (v != 0).to(_I32)

    def _step(self):
        R = self.tcur.shape[0]
        dev = self.dev
        zero = torch.zeros((R,), dtype=_I32, device=dev)
        fpi = self.fpi()

        active = ~self.done & ~self.err

        # ---- 1) process pending returns (no stack pointer moves) -----------
        retm = active & self.ret_valid
        at_root = retm & (self.fp < 0)
        self.done = self.done | at_root
        self.dirty_root = torch.where(at_root, self.ret_dirty, self.dirty_root)
        fr = retm & ~at_root
        case_r = self.top(self.f_case)
        sub_r = self.top(self.f_sub)
        acc = fr & _isin(case_r, (_F_CASE2, _F_CASE5, _F_CASE6, _F_CASE7))
        c4r = fr & (case_r == _F_CASE4) & (sub_r == _SUB_WAITING)
        bad = c4r & (self.ret_dirty == 0)
        self.err = self.err | bad
        good = c4r & ~bad
        c8r = fr & (case_r == _F_CASE8) & (sub_r == _SUB_WAITING)
        self._put(self.f_dirty, self._at(fpi, acc | good | c8r),
                  torch.where(acc, self.top(self.f_dirty) + self.ret_dirty, self.ret_dirty))
        self._put(self.f_flag, self._at(fpi, good), True)
        self._put(self.f_sub, self._at(fpi, good | c8r),
                  torch.where(good, _SUB_NONE, _SUB_DRAIN))
        self.ret_valid = self.ret_valid & ~retm
        active = active & ~retm & ~self.err

        # ---- 2) frame-top dispatch ----------------------------------------
        out_of_tok = active & (self.tcur >= self.ntok_r)
        self.err = self.err | out_of_tok
        active = active & ~out_of_tok

        tcur = self.tcur
        k = self.kind_at(tcur)
        case = self.top(self.f_case)
        sub = self.top(self.f_sub)
        style = self.top(self.f_style)
        fpath = self.top(self.f_path)
        faux = self.top(self.f_aux)
        fflag = self.top(self.f_flag)
        fdirty = self.top(self.f_dirty)

        is_root = active & (self.fp < 0) & ~self.entered_root
        self.entered_root = self.entered_root | is_root
        framed = active & (self.fp >= 0)

        close_arr = k == jt.END_ARRAY
        close_obj = k == jt.END_OBJECT

        # COPY
        copym = framed & (case == _F_COPY)
        prevk = self.kind_at(tcur - 1)
        sep_colon = prevk == jt.FIELD_NAME
        prev_valend = self.valend_tab[prevk]
        sep_comma = prev_valend & ~(close_arr | close_obj)
        s0t = torch.where(copym & (sep_colon | sep_comma), _SEG_CONST, zero)
        s0a = torch.where(copym & sep_colon, _C_COLON,
                          torch.where(copym & sep_comma, _C_COMMA, zero))
        s1t = torch.where(copym, _SEG_ESC_TOK, zero)
        s1a = torch.where(copym, tcur, zero)
        at_end = copym & (tcur == faux)
        tcur = torch.where(copym, tcur + 1, tcur)
        framed = framed & ~copym

        # CASE2
        c2 = framed & (case == _F_CASE2)
        c2_close = c2 & close_arr
        c2_enter = c2 & ~close_arr

        # CASE4
        c4 = framed & (case == _F_CASE4)
        c4_go = c4 & (sub == _SUB_ENTERING)
        c4 = c4 & (sub != _SUB_ENTERING)
        c4_close = c4 & close_obj
        c4_field = c4 & ~close_obj
        # per-row name match at (path level, current token)
        lvl = torch.clamp(fpath, 0, self.P1 - 1).to(_I64)
        slot = self.slot_f[self.pbase + lvl]
        nm = self.nm_f[slot * (self.n * self.T) + self.nmbase
                       + torch.clamp(tcur, 0, self.T - 1)]
        hit = c4_field & nm & ~fflag
        miss = c4_field & ~hit
        vt = tcur + 1
        vkind = self.kind_at(vt)
        vopen = (vkind == jt.START_OBJECT) | (vkind == jt.START_ARRAY)
        tcur = torch.where(miss, torch.where(vopen, self.match_at(vt) + 1, tcur + 2), tcur)
        isnull = vkind == jt.VALUE_NULL
        self.err = self.err | (hit & isnull)
        ok_hit = hit & ~isnull
        tcur = torch.where(ok_hit, tcur + 1, tcur)

        # CASE5 and CASE7 closes: the generator's depth drops, now non-empty
        c5 = framed & (case == _F_CASE5)
        c7 = framed & (case == _F_CASE7)
        c5_close = c5 & close_arr
        c7_close = c7 & close_arr
        c57_close = c5_close | c7_close
        s1t = torch.where(c57_close, _SEG_CONST, s1t)
        s1a = torch.where(c57_close, _C_CLOSE_ARR, s1a)
        gi = self._at(self.gpi(), c57_close)
        self._put(self.g_depth, gi, self.gtop(self.g_depth) - 1)
        self._put(self.g_empty, gi, False)
        c5_enter = c5 & ~close_arr
        c7_enter = c7 & ~close_arr

        # CASE6: the close resolves both conditionals (the dirty count and
        # need_comma are final now): it emits its constant and writes the
        # open's at the position the open took
        c6 = framed & (case == _F_CASE6)
        c6_close = c6 & close_arr
        open_id = torch.where(fdirty > 1, torch.where(fflag, _C_COMMA_OPEN, _C_OPEN_ARR),
                              torch.where((fdirty == 1) & fflag, _C_COMMA, _C_EMPTY))
        close_id = torch.where(fdirty > 1, _C_CLOSE_ARR, _C_EMPTY)
        self.seg.scatter_(1, self._at(faux.to(_I64)[:, None], c6_close),
                          _pack(torch.full_like(zero, _SEG_CONST), open_id)[:, None])
        s1t = torch.where(c6_close, _SEG_CONST, s1t)
        s1a = torch.where(c6_close, close_id, s1a)
        self._set_gp(torch.where(c6_close, self.gp - 1, self.gp))
        wrote = c6_close & (fdirty >= 1) & (self.gtop(self.g_depth) > 0)
        self._put(self.g_empty, self._at(self.gpi(), wrote), False)
        c6_enter = c6 & ~close_arr
        tcur = torch.where(c2_close | c4_close | c57_close | c6_close, tcur + 1, tcur)

        # CASE8
        c8 = framed & (case == _F_CASE8)
        c8_skip = c8 & (sub == _SUB_NONE) & (faux > 0)
        self.err = self.err | (c8_skip & close_arr)
        ok8 = c8_skip & ~close_arr
        isopen_k = (k == jt.START_OBJECT) | (k == jt.START_ARRAY)
        skip_cur = torch.where(isopen_k, self.match_at(tcur) + 1, tcur + 1)
        tcur = torch.where(ok8, skip_cur, tcur)
        c8_go = c8 & (sub == _SUB_NONE) & (faux <= 0) & ~c8_skip
        c8_drain = c8 & (sub == _SUB_DRAIN)
        d_close = c8_drain & close_arr
        d_skip = c8_drain & ~close_arr
        tcur = torch.where(d_skip, skip_cur, tcur)
        tcur = torch.where(d_close, tcur + 1, tcur)

        # the frame writes of this step's dispatch (rows that keep their
        # frame), then every return's pop at once
        self._put(self.f_sub, self._at(fpi, ok_hit | c4_go | c8_go),
                  torch.where(ok_hit, _SUB_ENTERING, _SUB_WAITING))
        self._put(self.f_aux, self._at(fpi, ok8), faux - 1)
        pop = at_end | c2_close | c4_close | c57_close | c6_close | d_close
        self.ret_valid = self.ret_valid | pop
        self.ret_dirty = torch.where(pop, torch.where(at_end, 1, fdirty), self.ret_dirty)
        self._set_fp(torch.where(pop, self.fp - 1, self.fp))

        # ---- 3) ENTER dispatch ------------------------------------------
        enter = is_root | c2_enter | c4_go | c5_enter | c6_enter | c7_enter | c8_go
        e_style = torch.where(
            c2_enter | c5_enter, _FLATTEN, torch.where(
                c7_enter | (c8_go & fflag), _QUOTED, torch.where(
                    c4_go | c6_enter | c8_go, style, _RAW))).to(_I8)
        e_path = torch.where(c2_enter, self.P1 - 1,
                             torch.where(c4_go, fpath + 1,
                                         torch.where(c5_enter | c6_enter | c7_enter | c8_go,
                                                     fpath, zero)))

        ep = torch.clamp(e_path, 0, self.P1 - 1).to(_I64)
        pt = self.ptype_f[self.pbase + ep]
        ptn = self.ptype_f[self.pbase + torch.clamp(ep + 1, max=self.P1 - 1)]
        path_end = pt == _P_END
        is_str = k == jt.VALUE_STRING
        is_arr = k == jt.START_ARRAY
        is_obj = k == jt.START_OBJECT
        mtch = self.match_at(tcur)

        gd = self.gtop(self.g_depth)
        need_comma = (gd > 0) & ~self.gtop(self.g_empty)

        m1 = enter & is_str & path_end & (e_style == _RAW)
        m2 = enter & is_arr & path_end & (e_style == _FLATTEN) & ~m1
        m3 = enter & path_end & ~m1 & ~m2
        rest = enter & ~path_end
        m4 = rest & is_obj & (pt == NAMED)
        wc = rest & is_arr & (pt == WILDCARD)
        m5 = wc & (ptn == WILDCARD)
        m6 = wc & (e_style != _QUOTED) & ~m5
        m7 = wc & ~m5 & ~m6
        m8 = rest & is_arr & (pt == INDEX)
        m12 = rest & ~m4 & ~wc & ~m8

        # case 3's validity, and the scalar leaves (cases 1, 3, 12) return
        badk = self.badk_tab[k]
        self.err = self.err | (m3 & badk)
        ok3 = m3 & ~badk
        opn = ok3 & (is_arr | is_obj)
        scal = m1 | (ok3 & ~opn)
        self.ret_valid = self.ret_valid | scal | m12
        self.ret_dirty = torch.where(scal, 1, torch.where(m12, 0, self.ret_dirty))

        # segments: case 1 (raw string), case 3 (copy), cases 5/7 (open
        # array), case 6 (conditional open)
        lead = (ok3 | m5 | m7) & need_comma
        s0t = torch.where(lead, _SEG_CONST, torch.where(m6, _SEG_COND_OPEN, s0t))
        s0a = torch.where(lead, _C_COMMA, s0a)
        s1t = torch.where(m1, _SEG_RAW_TOK, torch.where(
            ok3, _SEG_ESC_TOK, torch.where(m5 | m7, _SEG_CONST, s1t)))
        s1a = torch.where(m1 | ok3, tcur, torch.where(m5 | m7, _C_OPEN_ARR, s1a))

        # generator stack: cases 1/3 mark a write, 5/7 open a level, 6 pushes
        # a child generator
        gp = torch.where(m6, self.gp + 1, self.gp)
        overg = m6 & (gp >= self.G)
        self.err = self.err | overg
        self._set_gp(torch.where(overg, self.G - 1, gp))
        opens = m5 | m6 | m7
        gi = self.gpi()
        self._put(self.g_depth, self._at(gi, opens), torch.where(m6, 1, gd + 1))
        self._put(self.g_empty, self._at(gi, opens | ((m1 | ok3) & (gd > 0))), opens)

        # one push for cases 2-8 (disjoint rows)
        push = m2 | opn | m4 | opens | m8
        fp = torch.where(push, self.fp + 1, self.fp)
        over = push & (fp >= self.F)
        self.err = self.err | over
        self._set_fp(torch.where(over, self.F - 1, fp))
        fi = self._at(self.fpi(), push & ~over)
        self._put(self.f_case, fi, torch.where(
            m2, _F_CASE2, torch.where(opn, _F_COPY, torch.where(m4, _F_CASE4, torch.where(
                m5, _F_CASE5, torch.where(m6, _F_CASE6, torch.where(m7, _F_CASE7,
                                                                    _F_CASE8)))))))
        self._put(self.f_style, fi, torch.where(
            m2, _FLATTEN, torch.where(opn, _RAW, torch.where(
                m6, torch.where(e_style == _RAW, _QUOTED, _FLATTEN), e_style))))
        self._put(self.f_path, fi, torch.where(
            m2, self.P1 - 1, torch.where(opn, 0, torch.where(
                m4, e_path, torch.where(m5, e_path + 2, e_path + 1)))))
        self._put(self.f_dirty, fi, 0)
        self._put(self.f_sub, fi, _SUB_NONE)
        self._put(self.f_aux, fi, torch.where(
            opn, mtch, torch.where(m6, self.nseg, torch.where(
                m8, self.parg_f[self.pbase + ep], 0))))
        self._put(self.f_flag, fi, torch.where(m6, need_comma, m8 & (ptn == WILDCARD)))

        adv = m1 | m2 | ok3 | m4 | opens | m8
        tcur = torch.where(adv, tcur + 1, torch.where(
            m12, torch.where(is_arr | is_obj, mtch + 1, tcur + 1), tcur))
        self.tcur = tcur.to(_I32)
        self._emit(s0t, s0a)
        self._emit(s1t, s1a)


def run_scan(kind, match, ntok, ok, nm_tab, parts: Sequence[tuple], slots: Sequence[list],
             T: int, F: int, G: int):
    """Run every path of ``parts`` over one bucket's token stream.

    ``nm_tab``: [U + 1, n, T] bool name-match tables (the last all False);
    ``slots[p][level]`` is path p's table slot for each of its levels (None
    levels point at the last).  Returns ``(err [P, n], seg [P, n, K],
    n_truncated)``: the packed segments (type | arg << SEG_SHIFT) of each
    (path, row) in order.  The step cap is ``2T + 40``, as in the JAX
    package.
    """
    n = kind.shape[0]
    P = len(parts)
    dev = kind.device
    P1 = max(len(pt) for pt, _pa, _nm in parts) + 1
    U = nm_tab.shape[0] - 1
    ptype = torch.full((P, P1), _P_END, dtype=_I32)
    parg = torch.zeros((P, P1), dtype=_I32)
    slot = torch.full((P, P1), U, dtype=_I64)
    for p, (ptypes, pargs, _names) in enumerate(parts):
        for lv, (t, a) in enumerate(zip(ptypes, pargs)):
            ptype[p, lv] = t
            parg[p, lv] = a if isinstance(a, int) else 0
        for lv, s in enumerate(slots[p]):
            slot[p, lv] = U if s is None else s
    m = _Scan(kind, match, ntok, ok, nm_tab, ptype.to(dev), parg.to(dev), slot.to(dev), P,
              F, G)
    n_trunc = m.run(2 * T + 40)
    err, seg = m.segments()
    return err.reshape(P, n), seg.reshape(P, n, -1), n_trunc
