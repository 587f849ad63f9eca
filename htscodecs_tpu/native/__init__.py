"""Native host kernels: build-on-demand ctypes bindings.

Compiles ``hostkernels.c`` with the system compiler on first import
(cached next to the source, keyed by content hash) and exposes
numpy-friendly wrappers.  Everything degrades gracefully: if no
compiler is available the package falls back to the pure-Python oracle
engines.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "hostkernels.c"

_lib = None
_lib_lock = threading.Lock()


def _build() -> ctypes.CDLL | None:
    if not _SRC.exists():
        return None
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _HERE / f"_hostkernels_{tag}.so"
    if not so.exists():
        # per-process tmp name: two processes racing the first build
        # each compile privately, then atomically publish via replace
        tmp = _HERE / f".build_{tag}.{os.getpid()}.so"
        for cc in ("gcc", "cc", "clang"):
            try:
                r = subprocess.run(
                    [cc, "-O3", "-march=native", "-shared", "-fPIC",
                     "-o", str(tmp), str(_SRC), "-lm"],
                    capture_output=True, timeout=120,
                )
            except (OSError, subprocess.TimeoutExpired):
                continue
            if r.returncode == 0:
                tmp.replace(so)
                break
        else:
            return None
        if not so.exists():
            return None
    try:
        return ctypes.CDLL(str(so))
    except OSError:
        return None


def _sig(fn, res, args):
    fn.restype = res
    fn.argtypes = args
    return fn


def get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is not None:
                return _lib or None
            return _get_lib_locked()
    return _lib or None


def _get_lib_locked():
    global _lib
    lib = _build()
    if lib is None:
        _lib = False
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    _sig(lib.r16_enc_o0, i64, [u8p, i64, u8p, i64])
    _sig(lib.r16_enc_o1, i64, [u8p, i64, u8p, i64])
    _sig(lib.r16_dec_o0, i64, [u8p, i64, u8p, i64])
    _sig(lib.r16_dec_o1, i64, [u8p, i64, u8p, i64])
    _sig(lib.r16_build_tables_o0, i64, [u8p, i64, u8p, i64, u32p, u32p])
    _sig(lib.r16_build_tables_o1, i64, [u8p, i64, u8p, i64, u32p, u32p, i32p])
    _sig(lib.r16_parse_tables_o0, i64, [u8p, i64, u8p, u16p, u16p])
    _sig(lib.r16_parse_tables_o1, i64, [u8p, i64, u8p, u16p, u16p, i32p])
    _sig(lib.r16_build_tables_o1_dense, i64,
         [u8p, i64, u8p, i64, u8p, i32p, ctypes.c_int32, i32p, i32p])
    _sig(lib.r16_parse_tables_o1_dense, i64,
         [u8p, i64, u8p, i32p, ctypes.c_int32, i32p, i32p])
    _sig(lib.r8_build_tables_o0_dense, i64,
         [u8p, i64, u8p, i64, u8p, i32p, ctypes.c_int32, i32p])
    _sig(lib.r8_build_tables_o1_dense, i64,
         [u8p, i64, u8p, i64, u8p, i32p, ctypes.c_int32, i32p])
    i64p = ctypes.POINTER(ctypes.c_int64)
    _sig(lib.r16_serialize_o1_dense_batch, i64,
         [u8p, i32p, u16p, i32p, ctypes.c_int32, ctypes.c_int32,
          u8p, i64, i64p])
    _sig(lib.r16_serialize_o1_sparse12_batch, i64,
         [u8p, i32p, u8p, u8p, i32p, ctypes.c_int32, ctypes.c_int32,
          ctypes.c_int32, ctypes.c_int32, u8p, i64, i64p])
    _sig(lib.r16_serialize_o0_batch, i64,
         [u16p, ctypes.c_int32, u8p, i64, i64p])
    _sig(lib.tok3_tokenize, i64,
         [u8p, i64p, i64p, i64, u8p, i64, i64p, i32p])
    _sig(lib.tok3_detokenize, i64,
         [u8p, i64p, i64p, ctypes.c_int32, i64, u8p, i64])
    _sig(lib.r16_gather_params_o1, i64, [u8p, i64, u32p, u32p, u16p, u16p])
    for nm in ("arith_enc_o0", "arith_enc_o1", "arith_enc_o0_rle",
               "arith_enc_o1_rle", "arith_dec_o0", "arith_dec_o1",
               "arith_dec_o0_rle", "arith_dec_o1_rle"):
        _sig(getattr(lib, nm), i64, [u8p, i64, u8p, i64])
    c_int = ctypes.c_int
    _sig(lib.r16_compress_wrapped, i64,
         [u8p, i64, ctypes.c_int32, u8p, i64])
    _sig(lib.fqz_stats1, i64,
         [u8p, i64, i64p, i64p, i64, i64, u8p, i64p, i64p, i64p, i64p])
    _sig(lib.fqz_stats2, i64,
         [u8p, i64, i64p, i64p, i64, u8p, i64p])
    _sig(lib.fqz_enc, i64,
         [u8p, i64, u32p, u32p, i64, c_int, c_int, c_int, c_int, u8p,
          u32p, u32p, u32p, u32p, u32p, u8p, i64])
    _sig(lib.fqz_dec, i64,
         [u8p, i64, i64, c_int, c_int, c_int, c_int, u8p,
          u32p, u32p, u32p, u32p, u32p, u8p, u32p, u8p, i64])
    _lib = lib
    return _lib if _lib is not False else None


def available() -> bool:
    return get_lib() is not None


def _u8(arr) -> tuple:
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def enc_o0(data: np.ndarray) -> bytes | None:
    """Full order-0 block (freq header + payload)."""
    lib = get_lib()
    a, ap = _u8(data)
    cap = int(1.1 * len(a) + 4096)
    out = np.empty(cap, dtype=np.uint8)
    r = lib.r16_enc_o0(ap, len(a), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    return out[:r].tobytes() if r >= 0 else None


def enc_o1(data: np.ndarray) -> bytes | None:
    lib = get_lib()
    a, ap = _u8(data)
    cap = int(1.1 * len(a) + 257 * 257 * 3 + 4096)
    out = np.empty(cap, dtype=np.uint8)
    r = lib.r16_enc_o1(ap, len(a), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    return out[:r].tobytes() if r >= 0 else None


def dec_o0(blob, out_sz: int) -> np.ndarray | None:
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    out = np.empty(out_sz, dtype=np.uint8)
    r = lib.r16_dec_o0(ap, len(a), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_sz)
    return out if r >= 0 else None


def dec_o1(blob, out_sz: int) -> np.ndarray | None:
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    out = np.empty(out_sz, dtype=np.uint8)
    r = lib.r16_dec_o1(ap, len(a), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_sz)
    return out if r >= 0 else None


def _arith(fn_name: str, data, cap_or_sz: int, is_enc: bool):
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(data), dtype=np.uint8)
                if not isinstance(data, np.ndarray) else data)
    if is_enc:
        cap = int(len(a) * 1.1 + 4096)
        out = np.empty(cap, dtype=np.uint8)
        r = getattr(lib, fn_name)(ap, len(a),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        return out[:r].tobytes() if r >= 0 else None
    out = np.empty(cap_or_sz, dtype=np.uint8)
    r = getattr(lib, fn_name)(ap, len(a),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap_or_sz)
    return out if r >= 0 else None


def arith_enc(data, order1: bool, rle: bool) -> bytes | None:
    nm = f"arith_enc_o{1 if order1 else 0}{'_rle' if rle else ''}"
    return _arith(nm, data, 0, True)


def arith_dec(blob, out_sz: int, order1: bool, rle: bool) -> np.ndarray | None:
    nm = f"arith_dec_o{1 if order1 else 0}{'_rle' if rle else ''}"
    return _arith(nm, blob, out_sz, False)


def _u32p(a):
    return np.ascontiguousarray(a, dtype=np.uint32).ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint32))


def fqz_enc_scan(data, lens, flags, gp, packed) -> bytes | None:
    """Range-coded fqz payload (no varint/params header)."""
    lib = get_lib()
    pm_ints, qmaps, qtabs, ptabs, dtabs, stab = packed
    a, ap = _u8(data)
    lens32 = np.ascontiguousarray(lens, np.uint32)
    flags32 = np.ascontiguousarray(flags, np.uint32)
    cap = int(len(a) * 1.1 + 100000)
    out = np.empty(cap, np.uint8)
    r = lib.fqz_enc(
        ap, len(a), _u32p(lens32), _u32p(flags32), len(lens32),
        gp.gflags, gp.nparam, gp.max_sel, gp.max_sym,
        np.ascontiguousarray(stab, np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _u32p(pm_ints), _u32p(qmaps), _u32p(qtabs), _u32p(ptabs), _u32p(dtabs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    return out[:r].tobytes() if r >= 0 else None


def fqz_dec_scan(blob, total, gp, packed):
    """Returns (out u8 array, rec_lens, rec_revs, nrec) or None."""
    lib = get_lib()
    pm_ints, qmaps, qtabs, ptabs, dtabs, stab = packed
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    out = np.zeros(total, np.uint8)
    max_rec = total + 1
    rec_lens = np.zeros(max_rec, np.uint32)
    rec_revs = np.zeros(max_rec, np.uint8)
    r = lib.fqz_dec(
        ap, len(a), total,
        gp.gflags, gp.nparam, gp.max_sel, gp.max_sym,
        np.ascontiguousarray(stab, np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _u32p(pm_ints), _u32p(qmaps), _u32p(qtabs), _u32p(ptabs), _u32p(dtabs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _u32p(rec_lens),
        rec_revs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_rec)
    if r < 0:
        return None
    return out, rec_lens, rec_revs, int(r)


def build_tables_o0(data: np.ndarray):
    """Returns (header bytes, starts (256,) u32, freqs (256,) u32)."""
    lib = get_lib()
    a, ap = _u8(data)
    hdr = np.empty(257 * 3 + 16, dtype=np.uint8)
    st = np.empty(256, dtype=np.uint32)
    fr = np.empty(256, dtype=np.uint32)
    hl = lib.r16_build_tables_o0(
        ap, len(a), hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(hdr),
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        fr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if hl < 0:
        return None
    return hdr[:hl].tobytes(), st, fr


def build_tables_o1(data: np.ndarray):
    """Returns (header bytes, starts (256,256) u32, freqs, shift)."""
    lib = get_lib()
    a, ap = _u8(data)
    hdr = np.empty(257 * 257 * 3 + 64, dtype=np.uint8)
    st = np.empty((256, 256), dtype=np.uint32)
    fr = np.empty((256, 256), dtype=np.uint32)
    sh = ctypes.c_int32(0)
    hl = lib.r16_build_tables_o1(
        ap, len(a), hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(hdr),
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        fr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(sh))
    if hl < 0:
        return None
    return hdr[:hl].tobytes(), st, fr, int(sh.value)


import threading

_TLBUF = threading.local()


def _dense_bufs(max_a: int):
    """Per-thread scratch for the dense table builders (a fresh 200 KB
    np.empty per call costs more than the C work at small blocks)."""
    b = getattr(_TLBUF, "bufs", None)
    if b is None or b[3] < max_a:
        # worst-case header: alphabet + per-row freq deltas; the C side
        # compresses anything over 1000 B, but budget the raw size
        hdr = np.empty(257 * 257 * 3 + 64, dtype=np.uint8)
        alpha = np.empty(max_a, dtype=np.uint8)
        packed = np.empty(max_a * max_a, dtype=np.int32)
        b = (hdr, alpha, packed, max_a)
        _TLBUF.bufs = b
    return b


def build_tables_o1_dense(data: np.ndarray, max_a: int = 96):
    """Dense order-1 table build for the v2 engines.

    Returns (header bytes, alpha (a,) u8, packed (a,a) i32, shift) or
    None (error / alphabet wider than max_a -> caller falls back)."""
    lib = get_lib()
    a, ap = _u8(data)
    hdr, alpha, packed, _ = _dense_bufs(max_a)
    na = ctypes.c_int32(0)
    sh = ctypes.c_int32(0)
    hl = lib.r16_build_tables_o1_dense(
        ap, len(a), hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(hdr), alpha.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_a, ctypes.byref(na), ctypes.byref(sh))
    if hl < 0:
        return None
    n = na.value
    return (hdr[:hl].tobytes(), alpha[:n].copy(),
            packed[:n * n].reshape(n, n).copy(), int(sh.value))


def r8_build_tables_dense(data: np.ndarray, order: int, max_a: int = 96):
    """Dense rANS 4x8 table build (CRAM 3.0) for the v2 engines.

    Returns (serialised table bytes, alpha (a,) u8, packed i32 —
    (a,) for order 0, (a,a) for order 1) or None."""
    lib = get_lib()
    a, ap = _u8(data)
    hdr, alpha, packed, _ = _dense_bufs(max_a)
    na = ctypes.c_int32(0)
    fn = lib.r8_build_tables_o1_dense if order else lib.r8_build_tables_o0_dense
    tl = fn(ap, len(a), hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(hdr), alpha.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_a, ctypes.byref(na))
    if tl < 0:
        return None
    n = na.value
    pk = (packed[:n * n].reshape(n, n).copy() if order
          else packed[:n].copy())
    return hdr[:tl].tobytes(), alpha[:n].copy(), pk


def parse_tables_o1_dense(blob, max_a: int = 96):
    """Dense order-1 table parse for the v2 decoder.

    Returns (payload offset, alpha (a,) u8, packed (a,a) i32, shift)
    or None."""
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    _hdr, alpha, packed, _ = _dense_bufs(max_a)
    na = ctypes.c_int32(0)
    sh = ctypes.c_int32(0)
    off = lib.r16_parse_tables_o1_dense(
        ap, len(a), alpha.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_a, ctypes.byref(na), ctypes.byref(sh))
    if off < 0:
        return None
    n = na.value
    return (int(off), alpha[:n].copy(),
            packed[:n * n].reshape(n, n).copy(), int(sh.value))


def compress_wrapped(data: np.ndarray, order: int):
    """Full non-STRIPE transform-wrapper encode (pack/RLE/framing/CAT)
    in one native call; byte-identical to models/rans4x16.compress.
    Returns stream bytes or None (caller keeps the Python path)."""
    lib = get_lib()
    if lib is None:
        return None
    a, ap = _u8(data)
    n = len(a)
    cap = 3 * n + 2048 + 257 * 257 * 3
    buf = np.empty(cap, np.uint8)
    r = lib.r16_compress_wrapped(
        ap, n, order, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap)
    if r < 0:
        return None
    return buf[:r].tobytes()


def fqz_stats1(data: np.ndarray, st: np.ndarray, ls: np.ndarray,
               d2f: np.ndarray, nrec: int | None = None):
    """One-pass fqz picker statistics: (pos,sym) histograms (all /
    read-2), per-segment byte sums, adjacent-duplicate count (real
    records only — a trailing tail pseudo-segment never dedups).
    Returns (hb (128,256) i64, h2, sums (nseg,) i64, dedup) or None."""
    lib = get_lib()
    if lib is None:
        return None
    a, ap = _u8(data)
    nseg = len(st)
    if nrec is None:
        nrec = nseg
    st64 = np.ascontiguousarray(st, np.int64)
    ls64 = np.ascontiguousarray(ls, np.int64)
    df = np.ascontiguousarray(d2f, np.uint8)
    hb = np.empty((128, 256), np.int64)
    h2 = np.empty((128, 256), np.int64)
    sums = np.empty(max(nseg, 1), np.int64)
    dd = np.zeros(1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    r = lib.fqz_stats1(
        ap, len(a), st64.ctypes.data_as(i64p), ls64.ctypes.data_as(i64p),
        nseg, nrec, df.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        hb.ctypes.data_as(i64p), h2.ctypes.data_as(i64p),
        sums.ctypes.data_as(i64p), dd.ctypes.data_as(i64p))
    if r < 0:
        return None
    return hb, h2, sums[:nseg], int(dd[0])


def fqz_stats2(data: np.ndarray, st: np.ndarray, ls: np.ndarray,
               qb4: np.ndarray):
    """Selector-bin (pos,sym) histogram: k4 (4,128,256) i64 or None."""
    lib = get_lib()
    if lib is None:
        return None
    a, ap = _u8(data)
    nseg = len(st)
    st64 = np.ascontiguousarray(st, np.int64)
    ls64 = np.ascontiguousarray(ls, np.int64)
    qb = np.ascontiguousarray(qb4, np.uint8)
    k4 = np.empty((4, 128, 256), np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    r = lib.fqz_stats2(
        ap, len(a), st64.ctypes.data_as(i64p), ls64.ctypes.data_as(i64p),
        nseg, qb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        k4.ctypes.data_as(i64p))
    if r < 0:
        return None
    return k4


def serialize_o1_dense_batch(alphas: np.ndarray, asz: np.ndarray,
                             freqs: np.ndarray, shifts: np.ndarray):
    """Batched order-1 header serialisation from device-built tables.

    alphas (B, Apad) u8, asz (B,) i32, freqs (B, Apad, Apad) u16
    pre-shift normalised rows, shifts (B,) i32.  Returns a list of B
    header byte strings (byte-identical to r16_build_tables_o1_dense)
    or None."""
    lib = get_lib()
    if lib is None:
        return None
    B, Apad = alphas.shape
    al = np.ascontiguousarray(alphas, np.uint8)
    az = np.ascontiguousarray(asz, np.int32)
    fr = np.ascontiguousarray(freqs, np.uint16)
    sh = np.ascontiguousarray(shifts, np.int32)
    offs = np.empty(B + 1, np.int64)
    cap = int(B) * (3 * Apad * Apad + 3 * Apad + 80) + 64
    arena = np.empty(cap, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    u16 = ctypes.POINTER(ctypes.c_uint16)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    r = lib.r16_serialize_o1_dense_batch(
        al.ctypes.data_as(u8), az.ctypes.data_as(i32),
        fr.ctypes.data_as(u16), sh.ctypes.data_as(i32),
        B, Apad, arena.ctypes.data_as(u8), cap, offs.ctypes.data_as(i64))
    if r < 0:
        return None
    ab = arena.tobytes()
    return [ab[offs[b]:offs[b + 1]] for b in range(B)]


def serialize_o1_sparse12_batch(alphas: np.ndarray, asz: np.ndarray,
                                bitmap: np.ndarray, vals12: np.ndarray,
                                shifts: np.ndarray):
    """Batched order-1 header serialisation from the sparse 12-bit
    transport (ops/tables_v2.pack_freqs_sparse12): presence bitmap
    (B, ceil(Apad^2/8)) u8 + row-compacted packed values (B, VW) u8,
    where VW may be any prefix wide enough for the batch's max
    nonzero count.  Byte-identical to serialize_o1_dense_batch on the
    unpacked frequencies; validates row normalisation in C.  Returns
    a list of B header byte strings or None."""
    lib = get_lib()
    if lib is None:
        return None
    B, Apad = alphas.shape
    al = np.ascontiguousarray(alphas, np.uint8)
    az = np.ascontiguousarray(asz, np.int32)
    bm = np.ascontiguousarray(bitmap, np.uint8)
    vv = np.ascontiguousarray(vals12, np.uint8)
    sh = np.ascontiguousarray(shifts, np.int32)
    offs = np.empty(B + 1, np.int64)
    cap = int(B) * (3 * Apad * Apad + 3 * Apad + 80) + 64
    arena = np.empty(cap, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    r = lib.r16_serialize_o1_sparse12_batch(
        al.ctypes.data_as(u8), az.ctypes.data_as(i32),
        bm.ctypes.data_as(u8), vv.ctypes.data_as(u8),
        sh.ctypes.data_as(i32), B, Apad, bm.shape[1], vv.shape[1],
        arena.ctypes.data_as(u8), cap, offs.ctypes.data_as(i64))
    if r == -3:
        raise ValueError("serialize_o1_sparse12: prefix narrower than "
                         "the batch's max nonzero count")
    if r == -4:
        raise ValueError("serialize_o1_sparse12: context row total is "
                         "not a power of two <= 4096")
    if r < 0:
        return None
    ab = arena.tobytes()
    return [ab[offs[b]:offs[b + 1]] for b in range(B)]


def serialize_o0_batch(freqs: np.ndarray):
    """Batched order-0 header serialisation.  freqs (B, 256) u16
    pre-shift normalised counts.  Returns list of B header byte
    strings (byte-identical to r16_build_tables_o0) or None."""
    lib = get_lib()
    if lib is None:
        return None
    B = freqs.shape[0]
    fr = np.ascontiguousarray(freqs, np.uint16)
    offs = np.empty(B + 1, np.int64)
    cap = int(B) * (257 * 3 + 16) + 64
    arena = np.empty(cap, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    u16 = ctypes.POINTER(ctypes.c_uint16)
    i64 = ctypes.POINTER(ctypes.c_int64)
    r = lib.r16_serialize_o0_batch(
        fr.ctypes.data_as(u16), B, arena.ctypes.data_as(u8), cap,
        offs.ctypes.data_as(i64))
    if r < 0:
        return None
    ab = arena.tobytes()
    return [ab[offs[b]:offs[b + 1]] for b in range(B)]


MAX_TBLOCKS = 128 * 16


def tok3_tokenize(blk: bytes, starts: np.ndarray, lens: np.ndarray):
    """Native name tokeniser.  Returns ({tid: descriptor bytes},
    max_tok) or None (unsupported input -> Python path)."""
    lib = get_lib()
    a, ap = _u8(np.frombuffer(blk, dtype=np.uint8))
    st = np.ascontiguousarray(starts, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    nreads = len(st)
    dlens = np.zeros(MAX_TBLOCKS, np.int64)
    mt = ctypes.c_int32(0)
    cap = 2 * len(a) + 24 * nreads + 65536
    i64p = ctypes.POINTER(ctypes.c_int64)
    for _ in range(2):
        arena = np.empty(cap, np.uint8)
        r = lib.tok3_tokenize(
            ap, st.ctypes.data_as(i64p), ln.ctypes.data_as(i64p), nreads,
            arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            dlens.ctypes.data_as(i64p), ctypes.byref(mt))
        if r >= 0:
            desc = {}
            off = 0
            for t in range(MAX_TBLOCKS):
                if dlens[t]:
                    desc[t] = arena[off:off + dlens[t]].tobytes()
                    off += dlens[t]
            return desc, int(mt.value)
        if r <= -10:                 # arena too small: exact size given
            cap = int(-r - 10)
            continue
        return None
    return None


def tok3_detokenize(desc: dict, max_tok: int, nreads: int, out_cap: int):
    """Native token replay.  desc: {tid: decompressed bytes}.
    Returns the NUL-separated names blob or None (corrupt / Python
    path)."""
    lib = get_lib()
    doffs = np.full(MAX_TBLOCKS, 0, np.int64)
    dls = np.full(MAX_TBLOCKS, -1, np.int64)
    total = sum(len(b) for b in desc.values())
    arena = np.empty(max(total, 1), np.uint8)
    off = 0
    for t, b in desc.items():
        doffs[t] = off
        dls[t] = len(b)
        arena[off:off + len(b)] = np.frombuffer(b, np.uint8)
        off += len(b)
    out = np.empty(out_cap, np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    r = lib.tok3_detokenize(
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        doffs.ctypes.data_as(i64p), dls.ctypes.data_as(i64p),
        max_tok, nreads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_cap)
    if r < 0:
        return None
    return out[:r].tobytes()


def parse_tables_o0(blob):
    """Returns (header length, ssym u8[4096], sfreq u16, sbase u16)."""
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    ssym = np.empty(4096, dtype=np.uint8)
    sfreq = np.empty(4096, dtype=np.uint16)
    sbase = np.empty(4096, dtype=np.uint16)
    hl = lib.r16_parse_tables_o0(
        ap, len(a), ssym.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sfreq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        sbase.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if hl < 0:
        return None
    return int(hl), ssym, sfreq, sbase


def gather_params_o1(data: np.ndarray, starts: np.ndarray, freqs: np.ndarray):
    """Per-symbol (start, freq) u16 coding params in the batched
    engine's processing order.  Requires len(data) % 4 == 0.
    Returns (st (K,4), fr (K,4))."""
    lib = get_lib()
    a, ap = _u8(data)
    n = len(a)
    st32 = np.ascontiguousarray(starts, dtype=np.uint32)
    fr32 = np.ascontiguousarray(freqs, dtype=np.uint32)
    so = np.empty(n, dtype=np.uint16)
    fo = np.empty(n, dtype=np.uint16)
    w = lib.r16_gather_params_o1(
        ap, n,
        st32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        fr32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        so.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        fo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if w < 0:
        return None
    return so.reshape(-1, 4), fo.reshape(-1, 4)


def parse_tables_o1(blob):
    """Returns (payload offset, sfb (256,1<<shift) u8, f2d, b2d, shift)."""
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    sfb = np.empty(256 << 12, dtype=np.uint8)
    f2d = np.empty(65536, dtype=np.uint16)
    b2d = np.empty(65536, dtype=np.uint16)
    sh = ctypes.c_int32(0)
    off = lib.r16_parse_tables_o1(
        ap, len(a), sfb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        f2d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        b2d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.byref(sh))
    if off < 0:
        return None
    shift = int(sh.value)
    return (int(off), sfb[:256 << shift].reshape(256, 1 << shift),
            f2d.reshape(256, 256), b2d.reshape(256, 256), shift)
