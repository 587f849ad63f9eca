"""On-device rANS 4x16 frequency-table construction (orders 0 and 1).

Builds the per-block normalised frequency tables on the device instead
of the host: the histograms are int32 scatter-adds (the order-1 bigram
histogram of narrow alphabets a one-hot einsum, see _bigram_hist), and
the exact integer normalisation pipeline
(reference ``rANS_static4x16pr.c:116-161`` ``normalise_freq``) is
replayed bit-exactly in vectorised i32 lanes using a two-limb
emulation of the u64 fixed-point scale factor.

The 10-vs-12-bit shift heuristic (``rANS_static4x16pr.c:629-691``
``compute_shift``) accumulates f64 entropy estimates; the *decision*
is replicated here in f32 with exact integer ``x`` terms, and any
block whose margin ``|e10 - 1.01*e12|`` falls inside a conservative
band (where f32 rounding could flip the f64 comparison) is flagged for
the host builder, so emitted streams stay byte-exact in every case.

Serialised headers are produced by a single batched native call
(``r16_serialize_tables_o1_dense_batch``) from the device-computed
normalised frequencies; only the (B, A, A) u16 frequency array crosses
the device->host link.
"""

from __future__ import annotations

import functools
import math
import struct

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

TOT0 = 4096
PACK_SHIFT = 13
MAX_DENSE_A = 96
# Blocks per table-build dispatch: bounds the histogram temporaries
# (5.4 GB for the A <= 8 one-hot operands of 64 KiB blocks).
TILE = 2048
# Widest padded alphabet whose bigram histogram uses the one-hot
# einsum; wider ones scatter-add (see _bigram_hist).
EINSUM_MAX_A = 8
# f32 margin band around the e10/e12 threshold inside which the f64
# decision could differ; such blocks rebuild on the host.  Measured
# f32 error is < 1e-5 relative on 64 KiB blocks.
SHIFT_BAND = 1e-3


def _round_a(a: int) -> int:
    from . import rans_v2
    return rans_v2._round_a(a)


# ---------------------------------------------------------------------------
# host-precomputed log tables (exact C doubles, rounded to f32)

def _logbits64(x: float) -> float:
    """Bit-hack log from the reference (rANS_static4x16pr.c:619-622),
    replayed on exact f64 host arithmetic."""
    bits = struct.unpack("<q", struct.pack("<d", float(x)))[0]
    return (bits - 4606921278410026770) * 1.539095918623324e-16


@functools.lru_cache(maxsize=1)
def _log_consts():
    """(l10 (257,), l12 (257,), A_e (13,), B_e (13,)) f32 tables.

    flog(x) for integer x in [1, 4096] decomposes exactly as
    ``(K_e + x * 2^(52-e)) * k`` with e = floor(log2 x); A_e/B_e are
    those per-exponent constants so the device evaluates
    ``A[e] + x * B[e]`` without any table gather."""
    l10 = np.array([math.log(1024 + s) for s in range(257)], np.float32)
    l12 = np.array([math.log(4096 + s) for s in range(257)], np.float32)
    k = 1.539095918623324e-16
    C = 4606921278410026770
    A_e = np.array([((1022 + e) * (1 << 52) - C) * k for e in range(13)],
                   np.float64).astype(np.float32)
    B_e = np.array([float(1 << (52 - e)) * k for e in range(13)],
                   np.float64).astype(np.float32)
    return l10, l12, A_e, B_e


# ---------------------------------------------------------------------------
# exact integer helpers (i32 lanes)

def _pow2_ceil(v):
    """Reference round2 (rANS_static4x16pr.c:104-114); v==0 -> 0."""
    x = v - 1
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return jnp.where(v == 0, 0, x + 1)


def _tr_parts(tot, size):
    """tr = (tot<<31)//size + (1<<30)//size as an exact (hi, lo) pair
    with tr = hi*2^16 + lo, lo < 2^16.  All intermediates fit i32."""
    u = tot << 15                        # tot <= 4096 -> u <= 2^27
    q1 = u // size
    r1 = u % size                        # < size <= 2^17
    v1 = (r1 << 8) // size               # < 2^8
    r2 = (r1 << 8) % size
    v2 = (r2 << 8) // size               # < 2^8
    low16 = (v1 << 8) + v2               # (tot<<31)//size low 16 bits
    d2 = (1 << 30) // size
    losum = low16 + (d2 & 0xFFFF)
    hi = q1 + (d2 >> 16) + (losum >> 16)
    lo = losum & 0xFFFF
    return hi, lo


def _mul_shift31(F, hi, lo):
    """floor(F * (hi*2^16 + lo) / 2^31) exactly in i32 lanes.

    Valid while F <= size (so F*hi <= ~2^28): decompose the 64-bit
    product into byte-aligned partials whose discarded low bits can
    never carry across the >>31 boundary."""
    a = F * hi
    b = F * (lo >> 8)
    c = F * (lo & 0xFF)
    d = b + (c >> 8)
    g = a + (d >> 8)
    return g >> 15


def _norm_pass(F, size, tot):
    """One scaling pass of normalise_freq.  F (R, A) i32 with row sums
    == size; returns (scaled F, new sums, argmax of input rows)."""
    szc = jnp.maximum(size, 1)
    hi, lo = _tr_parts(tot, szc)
    imax = jnp.argmax(F, axis=1).astype(jnp.int32)
    P = _mul_shift31(F, hi[:, None], lo[:, None])
    P = jnp.where(F > 0, jnp.maximum(P, 1), 0)
    return P, jnp.sum(P, axis=1), imax


def _norm_freq_rows(F, size, tot):
    """Vectorised bit-exact normalise_freq (reference
    rANS_static4x16pr.c:116-161) over (R, A) i32 rows.

    size: raw row totals; tot: per-row normalisation target.  Rows
    with size == 0 pass through unchanged (all-zero)."""
    R, A = F.shape
    cols = jnp.arange(A, dtype=jnp.int32)[None, :]

    F1, acc1, imax1 = _norm_pass(F, size, tot)
    Fs1 = jnp.take_along_axis(F1, imax1[:, None], axis=1)[:, 0]
    adj1 = tot - acc1
    done1 = (adj1 >= 0) | ((Fs1 > -adj1) & (Fs1 // 2 >= -adj1))
    out1 = jnp.where((cols == imax1[:, None]) & done1[:, None],
                     F1 + adj1[:, None], F1)

    # retry pass on the pass-1 output, renormalising acc1 -> tot
    F2, acc2, imax2 = _norm_pass(F1, acc1, tot)
    Fs2 = jnp.take_along_axis(F2, imax2[:, None], axis=1)[:, 0]
    adj2 = tot - acc2
    done2 = (adj2 >= 0) | (Fs2 > -adj2)
    out2e = jnp.where((cols == imax2[:, None]) & done2[:, None],
                      F2 + adj2[:, None], F2)
    # hard path: peg the max symbol to 1 and absorb the remaining
    # deficit left-to-right, each symbol giving up to F[j]-1
    F2r = jnp.where(cols == imax2[:, None], 1, F2)
    D = -adj2 - (Fs2 - 1)
    cap = jnp.maximum(F2r - 1, 0)
    cum = jnp.cumsum(cap, axis=1) - cap
    absorbed = jnp.clip(D[:, None] - cum, 0, cap)
    out2h = F2r - absorbed
    out2 = jnp.where(done2[:, None], out2e, out2h)

    out = jnp.where(done1[:, None], out1, out2)
    return jnp.where((size > 0)[:, None], out, F)


def _log2_pow2(v):
    """Exact log2 of a power-of-two i32 (0 -> 0)."""
    k = jnp.zeros_like(v)
    for i in range(1, 13):
        k = k + (v >= (1 << i)).astype(jnp.int32)
    return k


def _flog32(x):
    """f32 evaluation of the reference fast_log for integer x >= 1."""
    _, _, A_e, B_e = _log_consts()
    jA = jnp.asarray(A_e)
    jB = jnp.asarray(B_e)
    e = jnp.zeros(x.shape, jnp.int32)
    for i in range(1, 13):
        e = e + (x >= (1 << i)).astype(jnp.int32)
    eoh = e[..., None] == jnp.arange(13, dtype=jnp.int32)
    Ae = jnp.sum(jnp.where(eoh, jA, 0.0), axis=-1)
    Be = jnp.sum(jnp.where(eoh, jB, 0.0), axis=-1)
    return Ae + x.astype(jnp.float32) * Be


def _table_lookup(idx, table):
    """Small-table lookup via one-hot masked sum (no gather)."""
    jt = jnp.asarray(table)
    oh = idx[..., None] == jnp.arange(jt.shape[0], dtype=jnp.int32)
    return jnp.sum(jnp.where(oh, jt, 0.0), axis=-1)


# ---------------------------------------------------------------------------
# histograms

def _scatter_hist(idx, B: int, width: int):
    """Exact per-block histogram: idx (B, N) i32 in [0, width) ->
    (B, width) i32 counts, one int32 scatter-add."""
    flat = jnp.arange(B, dtype=jnp.int32)[:, None] * width + idx
    return jnp.zeros((B * width,), jnp.int32).at[flat.reshape(-1)].add(
        1).reshape(B, width)


def _bigram_hist(ctx, dense, A: int):
    """(B, A, A) i32 counts of (context, symbol) pairs.

    Narrow alphabets take a bf16 one-hot einsum (exact: counts of a
    block < 2^24 accumulate in f32); on an H100 it beat the scatter-add
    3x at A = 8, where the scatter's atomics pile onto few bins.  At
    A = 48 and 96 the scatter-add was 7-15x faster and the einsum's
    operands (2 x B x N x A bf16) would not fit a 2048-block tile."""
    B = dense.shape[0]
    if A <= EINSUM_MAX_A:
        aio = jnp.arange(A, dtype=jnp.int32)
        c1 = (ctx[:, :, None] == aio[None, None, :]).astype(jnp.bfloat16)
        s1 = (dense[:, :, None] == aio[None, None, :]).astype(jnp.bfloat16)
        return jnp.einsum("bni,bnj->bij", c1, s1,
                          preferred_element_type=jnp.float32
                          ).astype(jnp.int32)
    return _scatter_hist(ctx * A + dense, B, A * A).reshape(B, A, A)


# ---------------------------------------------------------------------------
# order-1 device build

@jax.jit
def _presence_jit(blocks):
    """Per-block byte presence via bit-packed OR-reduce: (B, 256) bool
    + max alphabet size.  ~10x cheaper than a 256-bin compare-reduce
    (8 masked OR passes instead of 256 equality sums)."""
    d32 = blocks.astype(jnp.int32)
    w = (jnp.uint32(1) << (d32 & 31).astype(jnp.uint32))
    groups = []
    for gi in range(8):
        m = jnp.where(d32 >> 5 == gi, w, jnp.uint32(0))
        groups.append(lax.reduce(m, jnp.uint32(0), lax.bitwise_or, (1,)))
    bits = jnp.stack(groups, axis=1)                     # (B, 8) u32
    v = jnp.arange(256, dtype=jnp.int32)
    gsel = (v[None, :] >> 5) == jnp.arange(8, dtype=jnp.int32)[:, None]
    bv = jnp.sum(jnp.where(gsel[None], bits[:, :, None], jnp.uint32(0)),
                 axis=1)                                 # (B, 256)
    pres = ((bv >> (v & 31).astype(jnp.uint32)) & 1) != 0
    pres = pres.at[:, 0].set(True)
    return pres, jnp.max(jnp.sum(pres, axis=1))


@functools.partial(jax.jit, static_argnames=("A", "N"))
def _build_o1_jit(blocks, pres, A: int, N: int):
    """Per-tile order-1 table build.

    blocks (B, N) u8, pres (B, 256) bool on device.  Returns
      alpha  (B, A) u8   sorted alphabet, last-symbol padded
      packed (B, A, A) i32  (base<<13|freq) post-shift tables
      fhdr   (B, A, A) u16  pre-shift normalised freqs (header payload)
      meta   (B, 3) i32  [asz, shift, flag]; flag -> rebuild on host
    """
    B = blocks.shape[0]

    # ---- alphabet (reference forces symbol 0 present,
    # rANS_static4x16pr.c:731) ----
    vals = jnp.arange(256, dtype=jnp.int32)
    asz = jnp.sum(pres, axis=1).astype(jnp.int32)
    rank = jnp.cumsum(pres.astype(jnp.int32), axis=1) - 1      # (B,256)
    # alpha[k] = k-th present byte; pad by repeating the last symbol
    kio = jnp.arange(A, dtype=jnp.int32)
    oh = (rank[:, :, None] == kio[None, None, :]) & pres[:, :, None]
    alpha_raw = jnp.sum(jnp.where(oh, vals[None, :, None], 0), axis=1)
    alpha = lax.associative_scan(jnp.maximum, alpha_raw, axis=1)

    # ---- dense remap + bigram histogram ----
    from . import rans_v2
    dense = rans_v2._densify(blocks, alpha.astype(jnp.uint8))   # (B,N) i32
    ctx = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), dense[:, :-1]], axis=1)
    H = _bigram_hist(ctx, dense, A)
    # quarter-start fixups charged to context 0
    # (rANS_static4x16pr.c:736-739)
    q = N >> 2
    bio = jnp.arange(B, dtype=jnp.int32)
    for pos in (q, 2 * q, 3 * q):
        H = H.at[bio, 0, dense[:, pos]].add(1)
    T = jnp.sum(H, axis=2)                                      # (B,A)

    # ---- shift heuristic (compute_shift) ----
    l10t, l12t, _, _ = _log_consts()
    cap = _pow2_ceil(T)
    Fpos = H > 0
    ns = jnp.sum(Fpos, axis=2).astype(jnp.int32)
    Hc = jnp.maximum(H, 1)
    div = cap[:, :, None] // Hc
    sm10 = jnp.sum(Fpos & (div > 1024), axis=2).astype(jnp.int32)
    sm12 = jnp.sum(Fpos & (div > 4096), axis=2).astype(jnp.int32)
    l10 = _table_lookup(sm10, l10t)
    l12 = _table_lookup(sm12, l12t)
    Tc = jnp.maximum(T, 1)[:, :, None]
    x10 = jnp.clip((1024 * H) // Tc, 1, 1024)
    x12 = jnp.clip((4096 * H) // Tc, 1, 4096)
    t10 = H.astype(jnp.float32) * (l10[:, :, None] - _flog32(x10)) + 4.0
    t12 = H.astype(jnp.float32) * (l12[:, :, None] - _flog32(x12)) + 6.0
    e10 = jnp.sum(jnp.where(Fpos, t10, 0.0), axis=(1, 2))
    e12 = jnp.sum(jnp.where(Fpos, t12, 0.0), axis=(1, 2))
    S = cap
    S = jnp.where((ns < 64) & (S > 128), S // 2, S)
    S = jnp.where(S > 1024, S // 2, S)
    S = jnp.minimum(S, 4096)
    max_tot = jnp.max(S, axis=1)
    small = max_tot <= 1024
    # the C comparison is on the ratio (e10, e12 can both be negative:
    # the bit-hack log overestimates); IEEE inf/nan semantics match
    ratio = e10 / e12
    shift = jnp.where((ratio < 1.01) | small, 10, 12).astype(jnp.int32)
    band = jnp.isfinite(ratio) & (jnp.abs(ratio - 1.01) < SHIFT_BAND)
    flag = (band & ~small).astype(jnp.int32)

    # ---- per-row normalisation ----
    tot = jnp.where((shift[:, None] == 10) & (S > 1024), 1024, S)  # (B,A)
    Fn = _norm_freq_rows(H.reshape(B * A, A), T.reshape(B * A),
                         tot.reshape(B * A)).reshape(B, A, A)
    fhdr = Fn.astype(jnp.uint16)
    # scale the power-of-two row totals up to 1<<shift (norm_shift)
    sh = (shift[:, None] - _log2_pow2(tot))
    sh = jnp.where(T > 0, sh, 0)
    Fs = Fn << sh[:, :, None]
    base = jnp.cumsum(Fs, axis=2) - Fs
    packed = (base << PACK_SHIFT) | Fs
    padr = kio[None, :] >= asz[:, None]                        # (B,A)
    pad = padr[:, None, :] | padr[:, :, None]
    packed = jnp.where(pad, 0, packed)

    meta = jnp.stack([asz, shift, flag], axis=1)
    return alpha.astype(jnp.uint8), packed, fhdr, meta, H


# ---------------------------------------------------------------------------
# order-0 device build

@functools.partial(jax.jit, static_argnames=("A", "N"))
def _build_o0_jit(blocks, A: int, N: int):
    """Per-tile order-0 table build.  Returns
      alpha (B, A) u8, packed (B, A) i32,
      fhdr (B, 256) u16 pre-shift normalised freqs, asz (B,) i32."""
    B = blocks.shape[0]
    vals = jnp.arange(256, dtype=jnp.int32)
    F = _scatter_hist(blocks.astype(jnp.int32), B, 256)

    cap = min(1 << max(int(N - 1).bit_length(), 0), TOT0) if N > 0 else 0
    Fn = _norm_freq_rows(F, jnp.full((B,), N, jnp.int32),
                         jnp.full((B,), cap, jnp.int32))
    fhdr = Fn.astype(jnp.uint16)
    sh = 12 - int(math.log2(cap)) if cap else 0
    Fs = Fn << sh

    pres = (F > 0).at[:, 0].set(True)
    asz = jnp.sum(pres, axis=1).astype(jnp.int32)
    rank = jnp.cumsum(pres.astype(jnp.int32), axis=1) - 1
    kio = jnp.arange(A, dtype=jnp.int32)
    oh = (rank[:, :, None] == kio[None, None, :]) & pres[:, :, None]
    alpha_raw = jnp.sum(jnp.where(oh, vals[None, :, None], 0), axis=1)
    alpha = lax.associative_scan(jnp.maximum, alpha_raw, axis=1)

    base_full = jnp.cumsum(Fs, axis=1) - Fs                    # (B,256)
    pk_full = (base_full << PACK_SHIFT) | Fs
    pk = jnp.sum(jnp.where(oh, pk_full[:, :, None], 0), axis=1)
    padr = kio[None, :] >= asz[:, None]
    packed = jnp.where(padr, 0, pk).astype(jnp.int32)
    return alpha.astype(jnp.uint8), packed, fhdr, asz


# ---------------------------------------------------------------------------
# exact host replay of the shift decision for banded blocks

def _pick_shift_exact(H: np.ndarray, a: int) -> int:
    """Bit-exact sequential f64 replay of compute_shift
    (rANS_static4x16pr.c:629-691) on one block's dense histogram.

    Python floats are IEEE f64 with the same rounding as C, and the
    accumulation order (ctx rows ascending, symbols ascending) matches
    the reference loop, so the returned 10/12 decision is exact."""
    e10 = 0.0
    e12 = 0.0
    max_tot = 0
    for i in range(a):
        row = H[i]
        T = int(row.sum())
        cap = _pow2_ceil_int(T)
        ns = 0
        sm10 = sm12 = 0
        for j in range(a):
            f = int(row[j])
            if f and cap // f > 1024:
                sm10 += 1
            if f and cap // f > 4096:
                sm12 += 1
        l10 = math.log(1024 + sm10)
        l12 = math.log(4096 + sm12)
        for j in range(a):
            f = int(row[j])
            if not f:
                continue
            ns += 1
            x = int(1024.0 * f / T)
            e10 -= f * (_logbits64(x if x > 1 else 1) - l10)
            x = int(4096.0 * f / T)
            e12 -= f * (_logbits64(x if x > 1 else 1) - l12)
            e10 += 4
            e12 += 6
        if ns < 64 and cap > 128:
            cap //= 2
        if cap > 1024:
            cap //= 2
        if cap > 4096:
            cap = 4096
        if max_tot < cap:
            max_tot = cap
    try:
        ratio_lt = (e10 / e12) < 1.01
    except ZeroDivisionError:
        ratio_lt = math.inf * (1 if e10 >= 0 else -1) < 1.01 \
            if e10 != 0 else False
    return 10 if (ratio_lt or max_tot <= 1024) else 12


def _pow2_ceil_int(v: int) -> int:
    if not v:
        return 0
    v -= 1
    for s in (1, 2, 4, 8, 16):
        v |= v >> s
    return v + 1


# ---------------------------------------------------------------------------
# public batched builders

def build_o1_device_async(blocks, tile: int = TILE):
    """Device-side order-1 table build with NO host transfers.

    Returns (alpha_d (B,A) u8, packed_d (B,A,A) i32, fhdr_d (B,A,A)
    u16, meta_d (B,3) i32 [asz, shift, band-flag], H_d (B,A,A) i32,
    A), all on device, or None when the batch needs the host path:
    wide alphabet, tiny blocks, or N >= 2^23 (row totals and (r1<<8)
    must fit i32 in the two-limb normaliser — see _tr_parts /
    _mul_shift31).  Callers dispatch dependent device work (e.g. the
    encode scan) BEFORE pulling fhdr/meta to the host so the transfer
    overlaps compute."""
    B, N = blocks.shape
    if N >= (1 << 23) or N < 4:
        return None
    jb = blocks if isinstance(blocks, jax.Array) else jnp.asarray(blocks)
    pres, amax = _presence_jit(jb)
    if int(np.asarray(amax)) > MAX_DENSE_A:
        return None
    A = _round_a(int(np.asarray(amax)))
    outs = [_build_o1_jit(jb[t0:t0 + tile], pres[t0:t0 + tile], A, N)
            for t0 in range(0, B, tile)]
    if len(outs) == 1:
        cat = list(outs[0])
    else:
        cat = [jnp.concatenate([o[i] for o in outs]) for i in range(5)]
    return cat[0], cat[1], cat[2], cat[3], cat[4], A


def resolve_band_flags(meta: np.ndarray, H_d) -> np.ndarray:
    """Resolve shift-band flags by replaying the f64 heuristic exactly
    on the device histograms; returns the final flag vector where 1
    means the decision actually flips (host rebuild needed)."""
    asz, shift, flag = meta[:, 0], meta[:, 1], meta[:, 2].copy()
    if flag.any():
        flat = np.flatnonzero(flag)
        Hsel = np.asarray(H_d[flat])
        for k, b in enumerate(flat):
            if _pick_shift_exact(Hsel[k], int(asz[b])) == shift[b]:
                flag[b] = 0
    return flag


def build_o1_device(blocks, tile: int = TILE):
    """Device order-1 table build over a (B, N) u8 batch.

    Returns (alpha (B,A) u8 dev, packed (B,A,A) i32 dev, asz (B,) np,
    fhdr (B,A,A) u16 np, shift (B,) np, flag (B,) np, A) or None when
    the batch needs the host path (wide alphabet / giant blocks)."""
    r = build_o1_device_async(blocks, tile)
    if r is None:
        return None
    alpha_d, packed_d, fhdr_d, meta_d, H_d, A = r
    # one bulk transfer per output
    fhdr = np.asarray(fhdr_d)
    meta = np.asarray(meta_d)
    flag = resolve_band_flags(meta, H_d)
    return (alpha_d, packed_d, meta[:, 0], fhdr, meta[:, 1], flag, A)


def build_o0_device(blocks, tile: int = TILE):
    """Device order-0 table build.  Returns (alpha dev, packed dev,
    asz np, fhdr (B,256) u16 np, A) or None."""
    B, N = blocks.shape
    if N >= (1 << 23) or N < 1:
        return None
    jb = blocks if isinstance(blocks, jax.Array) else jnp.asarray(blocks)
    pres, amax = _presence_jit(jb)
    if int(np.asarray(amax)) > MAX_DENSE_A:
        return None
    A = _round_a(int(np.asarray(amax)))
    outs = [_build_o0_jit(jb[t0:t0 + tile], A, N)
            for t0 in range(0, B, tile)]
    alpha_d = (outs[0][0] if len(outs) == 1
               else jnp.concatenate([o[0] for o in outs]))
    packed = (outs[0][1] if len(outs) == 1
              else jnp.concatenate([o[1] for o in outs]))
    fhdr = np.asarray(outs[0][2] if len(outs) == 1
                      else jnp.concatenate([o[2] for o in outs]))
    asz = np.asarray(outs[0][3] if len(outs) == 1
                     else jnp.concatenate([o[3] for o in outs]))
    return alpha_d, packed, asz, fhdr, A


# ---------------------------------------------------------------------------
# 12-bit header-frequency transport (D2H shrink for the serializer)
#
# The O1 header serializer only needs the normalised per-context
# frequency VALUES on the host; the u16 (B, A, A) transfer is pure
# transport.  Values are <= 1<<shift <= 4096, so 12 bits per entry (3
# bytes per pair) moves 25% less than u16 over the device->host
# link.  The single 13-bit value 4096 (a one-symbol
# context row normalised to the full 1<<12) is stored as 4095:
# every context row is normalised to a POWER-OF-TWO total <= 1<<shift
# (the per-row norm of rANS_static4x16pr.c's order-1 build), so a row
# summing to exactly 4095 is legitimately unreachable and the host
# restores its unique 4095 entry to 4096.


@jax.jit
def pack_freqs12(fhdr):
    """(B, A, A) u16 normalised freqs -> (B, 3*ceil(A*A/2)) u8."""
    B = fhdr.shape[0]
    v = fhdr.reshape(B, -1).astype(jnp.uint32)
    v = v - (v == 4096).astype(jnp.uint32)
    if v.shape[1] % 2:
        v = jnp.concatenate([v, jnp.zeros((B, 1), jnp.uint32)], axis=1)
    v0 = v[:, 0::2]
    v1 = v[:, 1::2]
    b0 = v0 & 0xFF
    b1 = (v0 >> 8) | ((v1 & 0xF) << 4)
    b2 = v1 >> 4
    return jnp.stack([b0, b1, b2], axis=2).reshape(
        B, -1).astype(jnp.uint8)


def unpack_freqs12_host(pk: np.ndarray, A: int) -> np.ndarray:
    """Invert pack_freqs12 on the host: (B, 3*ceil(A*A/2)) u8 ->
    (B, A, A) u16, restoring any 4096 entry via the row-sum deficit."""
    B = pk.shape[0]
    p = pk.reshape(B, -1, 3).astype(np.uint16)
    v0 = p[:, :, 0] | ((p[:, :, 1] & 0xF) << 8)
    v1 = (p[:, :, 1] >> 4) | (p[:, :, 2] << 4)
    v = np.stack([v0, v1], axis=2).reshape(B, -1)[:, :A * A]
    v = np.ascontiguousarray(v.reshape(B, A, A))
    rs = v.sum(axis=2, dtype=np.int64)
    fix = rs == 4095          # only a packed 4096 can produce this sum
    if fix.any():
        bi, ri = np.nonzero(fix)
        idx = v[bi, ri].argmax(axis=1)
        v[bi, ri, idx] += 1
        rs[fix] += 1
    # transport sanity: every legitimate context row is
    # normalised to a power-of-two total <= 4096 (or is all-zero for an
    # unused context).  A non-normalised input would otherwise corrupt
    # silently through the 12-bit wrap + 4095-restore heuristic.
    bad = (rs != 0) & ((rs & (rs - 1)) != 0) | (rs > 4096)
    if bad.any():
        b0, r0 = np.argwhere(bad)[0]
        raise ValueError(
            "unpack_freqs12: context row sum is not a power of two "
            f"<= 4096 (block {b0}, row {r0}, sum {int(rs[b0, r0])}) — "
            "input was not a normalised O1 frequency header")
    return v


# ---------------------------------------------------------------------------
# Sparse 12-bit transport (round 4): real O1 tables are 40-70% zeros
# (unseen context transitions), so shipping a presence bitmap plus the
# 12-bit-packed NONZERO values moves another ~35% less than the dense
# p12 form.  The nonzeros are compacted to the front of each row on
# device (one stable sort keyed by position), so the host D2H can pull
# just a prefix whose width covers the batch's max nonzero count.


@jax.jit
def pack_freqs_sparse12(fhdr):
    """(B, A, A) u16 -> (bitmap (B, ceil(E/8)) u8,
    vals12 (B, 3*ceil(E/2)) u8 with each row's nonzeros packed first,
    counts (B,) i32, maxnz () i32).  E = A*A."""
    B = fhdr.shape[0]
    v = fhdr.reshape(B, -1).astype(jnp.int32)
    v = v - (v == 4096).astype(jnp.int32)          # 4096 -> 4095 wrap
    E = v.shape[1]
    nz = v > 0
    # presence bitmap, LSB-first within each byte
    E8 = -(-E // 8) * 8
    nzp = nz
    if E8 > E:
        nzp = jnp.concatenate(
            [nz, jnp.zeros((B, E8 - E), bool)], axis=1)
    bits = nzp.reshape(B, E8 // 8, 8).astype(jnp.uint32)
    w = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint32)
    bitmap = jnp.sum(bits * w[None, None, :], axis=2).astype(jnp.uint8)
    # stable compaction of nonzero values to the row front
    iota = jnp.arange(E, dtype=jnp.int32)[None, :]
    key = jnp.where(nz, iota, jnp.int32(E)) * 8192 + v
    svals = lax.sort(key, dimension=1) & 8191
    counts = nz.sum(axis=1).astype(jnp.int32)
    # 12-bit pack (3 bytes per value pair)
    if E % 2:
        svals = jnp.concatenate(
            [svals, jnp.zeros((B, 1), jnp.int32)], axis=1)
    v0 = svals[:, 0::2]
    v1 = svals[:, 1::2]
    b0 = v0 & 0xFF
    b1 = (v0 >> 8) | ((v1 & 0xF) << 4)
    b2 = v1 >> 4
    vals12 = jnp.stack([b0, b1, b2], axis=2).reshape(
        B, -1).astype(jnp.uint8)
    return bitmap, vals12, counts, jnp.max(counts)


def unpack_freqs_sparse12_host(bitmap: np.ndarray, vals12: np.ndarray,
                               A: int) -> np.ndarray:
    """Invert pack_freqs_sparse12: vals12 may be any prefix of the
    packed value rows wide enough for the batch's max count."""
    B = bitmap.shape[0]
    E = A * A
    bits = np.unpackbits(bitmap, axis=1, bitorder="little")[:, :E]
    counts = bits.sum(axis=1).astype(np.int64)
    # unpack the 12-bit value stream
    p = vals12.reshape(B, -1, 3).astype(np.uint16)
    v0 = p[:, :, 0] | ((p[:, :, 1] & 0xF) << 8)
    v1 = (p[:, :, 1] >> 4) | (p[:, :, 2] << 4)
    sv = np.stack([v0, v1], axis=2).reshape(B, -1)
    if int(counts.max(initial=0)) > sv.shape[1]:
        raise ValueError("unpack_freqs_sparse12: prefix narrower than "
                         "the batch's max nonzero count")
    # rank-of-nonzero gather: position e holds the (cumsum-1)'th
    # compacted value of its row.  One vectorized take_along_axis beats
    # the nonzero/repeat scatter ~4x at B=12k, E=2.3k (single core).
    ranks = bits.cumsum(axis=1, dtype=np.int32) - 1
    np.maximum(ranks, 0, out=ranks)
    v = np.take_along_axis(sv, ranks, axis=1)
    v[bits == 0] = 0
    v = np.ascontiguousarray(v.reshape(B, A, A))
    rs = v.sum(axis=2, dtype=np.int64)
    fix = rs == 4095
    if fix.any():
        bi2, ri2 = np.nonzero(fix)
        idx = v[bi2, ri2].argmax(axis=1)
        v[bi2, ri2, idx] += 1
        rs[fix] += 1
    bad = (rs != 0) & ((rs & (rs - 1)) != 0) | (rs > 4096)
    if bad.any():
        b0, r0 = np.argwhere(bad)[0]
        raise ValueError(
            "unpack_freqs_sparse12: context row sum is not a power of "
            f"two <= 4096 (block {b0}, row {r0}, sum {int(rs[b0, r0])})")
    return v
