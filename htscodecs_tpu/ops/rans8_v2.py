"""Batched rANS 4x8 XLA engines (CRAM 3.0), dense-alphabet form.

Same design as the 4x16 engines (ops/rans_v2.py) with the rANS_byte.h
parameters (reference: htscodecs/rANS_byte.h:62,281-315,439-457):
L = 1<<23, x_max = ((L >> 12) << 8) * freq, up to TWO byte
emissions/consumptions per symbol, TOTFREQ fixed at 4096.  The
interleave layouts follow rANS_static.c: order-0 codes every symbol
i -> state i&3 (the decoder reads the final partial group from the
states without advancing them, rANS_static.c:346-355); order-1 uses
the same four-quarter layout as 4x16.

Dense tables, the TRANSPOSED lanes/alphabet-major layout, the
byte-exact step variants (take row fetch, fine/xfine renorm windows)
and the two-level sort compaction are all shared with rans_v2.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import rans_v2
from .rans_v2 import PACK_MASK, PACK_SHIFT, _densify, _undensify

RANS8_L = 1 << 23
SHIFT = 12
CHUNK = 128
R8 = 16              # inner steps per refill: 127 + 8*16 <= 255


# ---------------------------------------------------------------------------
# encode

@functools.partial(jax.jit, static_argnames=("order", "seg_cap",
                                             "row_fetch"))
def _enc_scan8(blocks, alpha, packed, order: int,
               seg_cap: int = rans_v2.SEG_CAP,
               row_fetch: str = "onehot"):
    """Returns (states (B,4) u32, bytes (B, cap) u16-valued, counts,
    overflow).  TRANSPOSED layout like rans_v2._enc_scan_impl (lanes
    and alphabet major, block axis minor)."""
    B, N = blocks.shape
    A = packed.shape[1]
    dense = _densify(blocks, alpha)
    take_rows = row_fetch == "take" and order == 1
    if take_rows:
        tbl = packed.reshape(B * A, A)                        # row = b*A+ctx
        brangeA = (jnp.arange(B, dtype=jnp.int32) * A)[None, :]
        iota_r = jnp.arange(A, dtype=jnp.int32)
        packedT = None
    elif order == 1:
        packedT = jnp.transpose(packed, (1, 2, 0))            # (A,A,B)
    else:
        packedT = jnp.transpose(packed, (1, 0))[:, None, :]   # (A,1,B)

    if order == 1:
        q = N >> 2
        tail = N - 4 * q
        D4 = dense[:, :4 * q].reshape(B, 4, q)
        # main steps (processing order k = q-2..0): ctx D4[:,:,k],
        # sym D4[:,:,k+1] — built as (K, 4, B)
        sym_main = jnp.transpose(D4[:, :, 1:][:, :, ::-1], (2, 1, 0))
        ctx_main = jnp.transpose(D4[:, :, :-1][:, :, ::-1], (2, 1, 0))
        if tail:
            idx = N - 1 - jnp.arange(tail)
            st3 = dense[:, idx]                               # (B, tail)
            ct3 = dense[:, idx - 1]
            sym_t = jnp.zeros((tail, 4, B), jnp.int32).at[:, 3, :].set(st3.T)
            ctx_t = jnp.zeros((tail, 4, B), jnp.int32).at[:, 3, :].set(ct3.T)
            parts_s = [sym_t, sym_main]
            parts_c = [ctx_t, ctx_main]
        else:
            parts_s = [sym_main]
            parts_c = [ctx_main]
        parts_s.append(jnp.transpose(D4[:, :, 0], (1, 0))[None])
        parts_c.append(jnp.zeros((1, 4, B), jnp.int32))
        sym_p = jnp.concatenate(parts_s, axis=0)              # (K,4,B)
        ctx_p = jnp.concatenate(parts_c, axis=0)
        K = tail + q
        valid = jnp.ones((K, 4, B), bool)
        if tail:
            v = jnp.zeros((tail, 4), bool).at[:, 3].set(True)
            valid = valid.at[:tail].set(
                jnp.broadcast_to(v[:, :, None], (tail, 4, B)))
        # processing order within a step is state 3 first
        sym_p = sym_p[:, ::-1, :]
        ctx_p = ctx_p[:, ::-1, :]
        valid = valid[:, ::-1, :]
    else:
        K = -(-N // 4)
        pad = K * 4 - N
        dpad = jnp.pad(dense, ((0, 0), (0, pad)))
        sy = dpad.reshape(B, K, 4)
        sym_p = jnp.transpose(sy, (1, 2, 0))[::-1, ::-1, :]   # (K,4,B)
        ctx_p = jnp.zeros_like(sym_p)
        valid = jnp.ones((K, 4, B), bool)
        if pad:
            vlast = jnp.zeros((4,), bool).at[4 - pad:].set(True)
            valid = valid.at[0].set(
                jnp.broadcast_to(~vlast[::-1][:, None], (4, B)))
        sym_p = jnp.where(valid, sym_p, 0)
    sym_p = sym_p.astype(jnp.uint8)
    ctx_p = ctx_p.astype(jnp.uint8)

    x0 = jnp.full((4, B), RANS8_L, dtype=jnp.uint32)
    xmax_mult = jnp.uint32((RANS8_L >> SHIFT) << 8)
    iota_a = jnp.arange(A, dtype=jnp.int32)[:, None, None]

    def step(x, inp):
        ctx, sym, ok = inp                                    # (4,B)
        ctx = ctx.astype(jnp.int32)
        sym = sym.astype(jnp.int32)
        if take_rows:
            idx = (brangeA + ctx).reshape(-1)                 # (4B,)
            row = jnp.take(tbl, idx, axis=0,
                           mode='clip').reshape(4, B, A)
            ohs = sym[:, :, None] == iota_r                   # (4,B,A)
            val = jnp.sum(jnp.where(ohs, row, 0), axis=2)     # (4,B)
        else:
            if order == 1:
                ohc = ctx[None, :, :] == iota_a               # (A,4,B)
                row = jnp.sum(jnp.where(ohc[:, None, :, :],
                                        packedT[:, :, None, :], 0),
                              axis=0)                         # (A,4,B)
            else:
                row = packedT                                 # (A,1,B)
            ohs = sym[None, :, :] == iota_a
            val = jnp.sum(jnp.where(ohs, row, 0), axis=0)     # (4,B)
        start = (val >> PACK_SHIFT).astype(jnp.uint32)
        freq = (val & PACK_MASK).astype(jnp.uint32)
        freq_s = jnp.where(ok, freq, jnp.uint32(1))
        x_max = xmax_mult * freq
        bs, es = [], []
        for _ in range(2):
            emit = (x >= x_max) & ok
            bs.append((x & jnp.uint32(0xFF)).astype(jnp.uint16))
            es.append(emit)
            x = jnp.where(emit, x >> 8, x)
        qq = x // freq_s
        newx = (qq << SHIFT) + (x - qq * freq_s) + start
        x = jnp.where(ok, newx, x)
        return x, (jnp.stack(bs, axis=0), jnp.stack(es, axis=0))

    xf, (bytes_, emits) = lax.scan(step, x0, (ctx_p, sym_p, valid),
                                   unroll=rans_v2.ENC_UNROLL)

    # forward stream order = full reverse of emission order: reversed
    # steps, reversed emission pair, reversed lanes; (K,2,4,B) ->
    # (B, K*8) with k-major, lane, emission-index minor.
    w = jnp.transpose(bytes_[::-1, ::-1, ::-1, :],
                      (3, 0, 2, 1)).reshape(B, K * 8)
    e = jnp.transpose(emits[::-1, ::-1, ::-1, :],
                      (3, 0, 2, 1)).reshape(B, K * 8)
    w, e = lax.optimization_barrier((w, e))
    out, n, overflow = rans_v2._compact(w, e, seg_cap)
    return jnp.transpose(xf, (1, 0))[:, ::-1], out, n, overflow


def _enc8(blocks, alpha, packed, order: int):
    rf = rans_v2._ENC_VARIANT["row_fetch"] if order == 1 else "onehot"
    xf, out, n, ovf = _enc_scan8(blocks, alpha, packed, order,
                                 row_fetch=rf)
    if bool(np.asarray(ovf)):
        xf, out, n, _ = _enc_scan8(blocks, alpha, packed, order,
                                   seg_cap=rans_v2.SEG, row_fetch=rf)
    return np.asarray(xf), np.asarray(out), np.asarray(n)


def enc_o0_batch(blocks: np.ndarray, alpha, packed):
    """Returns (states (B,4) u32, byte stream (B,cap) u16-valued,
    counts)."""
    return _enc8(jnp.asarray(blocks), jnp.asarray(alpha),
                 jnp.asarray(packed), 0)


def enc_o1_batch(blocks: np.ndarray, alpha, packed):
    return _enc8(jnp.asarray(blocks), jnp.asarray(alpha),
                 jnp.asarray(packed), 1)


# ---------------------------------------------------------------------------
# decode

@functools.partial(jax.jit, static_argnames=("K", "q", "order", "win",
                                             "row_fetch"))
def _dec_scan8(X0, chunks, packed, K: int, q: int, order: int,
               win: str = "coarse", row_fetch: str = "onehot"):
    """Byte-renorm decode scan, TRANSPOSED layout (lanes/alphabet
    major, block axis B minor — see rans_v2._dec_scan_impl).
    Returns dense symbols (KO*R, 4, B) u8 and final states (4, B).

    ``win`` mirrors rans_v2's window variants (byte-exact): 'coarse'
    = 256-wide window refilled every 16 steps, 'fine'/'xfine' = 64/32
    wide from 16-byte rows (each step consumes <= 8 bytes: 4 lanes x
    up to 2 renorm bytes).  ``row_fetch='take'`` fetches per-lane
    order-1 context rows via jnp.take instead of the O(A^2) one-hot."""
    B = X0.shape[0]
    NC = chunks.shape[0] // B
    mask = jnp.uint32((1 << SHIFT) - 1)
    A = packed.shape[1]
    take_rows = row_fetch == "take" and order == 1
    if win in rans_v2._WIN_PARAMS:
        # byte engine consumes <= 8/step (no unroll): ignore the DU
        # member, the window bounds stay safe for every variant
        W, NROWS, R, _DU = rans_v2._WIN_PARAMS[win]
    else:
        W, R = 2 * CHUNK, R8
    KO = -(-K // R)
    if take_rows:
        tbl = packed.reshape(B * A, A)                      # row = b*A+ctx
        brangeA = (jnp.arange(B, dtype=jnp.int32) * A)[None, :]
        iota_r = jnp.arange(A, dtype=jnp.int32)             # (A,) minor
        packedT = None
    elif order == 1:
        packedT = jnp.transpose(packed, (1, 2, 0))          # (A,A,B)
    else:
        packedT = jnp.transpose(packed, (1, 0))[:, None, :] # (A,1,B)
    lane3 = (jnp.arange(4, dtype=jnp.int32) == 3)[:, None]  # (4,1)
    iota_a = jnp.arange(A, dtype=jnp.int32)[:, None, None]  # (A,1,1)
    iota_w = jnp.arange(W, dtype=jnp.int32)[:, None, None]

    def one(X, p, ctx, s, winT, base):
        # X/ctx (4,B); p (B,)
        m = (X & mask).astype(jnp.int32)
        if order == 1:
            act = (s < q) | ((s < K) & lane3)               # (4,B)
        else:
            act = jnp.broadcast_to(s < K, (4, B))
        if take_rows:
            idx = (brangeA + ctx).reshape(-1)               # (4B,)
            row = jnp.take(tbl, idx, axis=0,
                           mode='clip').reshape(4, B, A)
            rb = row >> PACK_SHIFT
            rf = row & PACK_MASK
            ok = (rb <= m[:, :, None]) & (rf > 0)           # (4,B,A)
            symd = jnp.max(jnp.where(ok, iota_r, 0), axis=2)
            ohs = symd[:, :, None] == iota_r
            b = jnp.sum(jnp.where(ohs & (rf > 0), rb, 0),
                        axis=2).astype(jnp.uint32)
            f = jnp.sum(jnp.where(ohs & (rf > 0), rf, 0),
                        axis=2).astype(jnp.uint32)
        else:
            if order == 1:
                ohc = ctx[None, :, :] == iota_a             # (A,4,B)
                row = jnp.sum(jnp.where(ohc[:, None, :, :],
                                        packedT[:, :, None, :], 0),
                              axis=0)                       # (A,4,B)
            else:
                row = packedT                               # (A,1,B)
            rb = row >> PACK_SHIFT
            rf = row & PACK_MASK
            ok = (rb <= m[None]) & (rf > 0)                 # (A,4,B)
            symd = jnp.max(jnp.where(ok, iota_a, 0), axis=0)
            ohs = symd[None, :, :] == iota_a
            b = jnp.sum(jnp.where(ohs & (rf > 0), rb, 0),
                        axis=0).astype(jnp.uint32)
            f = jnp.sum(jnp.where(ohs & (rf > 0), rf, 0),
                        axis=0).astype(jnp.uint32)
        Xn = f * (X >> SHIFT) + m.astype(jnp.uint32) - b
        # Up to two byte consumptions per lane, lane 0 fully before
        # lane 1 etc.  Whether a second byte is needed is independent
        # of the first byte's value ((X<<8)|b < L  <=>  X < L>>8), so
        # all offsets are known before any fetch.
        need1 = (Xn < jnp.uint32(RANS8_L)) & act
        need2 = need1 & (Xn < jnp.uint32(RANS8_L >> 8))
        c = need1.astype(jnp.int32) + need2.astype(jnp.int32)  # (4,B)
        startl = (p[None, :] - base[None, :]) + \
            (jnp.cumsum(c, axis=0) - c)
        off1 = jnp.where(need1, startl, W)
        off2 = jnp.where(need2, startl + 1, W)
        sel1 = off1[None, :, :] == iota_w                   # (W,4,B)
        sel2 = off2[None, :, :] == iota_w
        b1 = jnp.sum(jnp.where(sel1, winT[:, None, :], jnp.uint32(0)),
                     axis=0, dtype=jnp.uint32)
        b2 = jnp.sum(jnp.where(sel2, winT[:, None, :], jnp.uint32(0)),
                     axis=0, dtype=jnp.uint32)
        Xn = jnp.where(need1, (Xn << 8) | (b1 & jnp.uint32(0xFF)), Xn)
        Xn = jnp.where(need2, (Xn << 8) | (b2 & jnp.uint32(0xFF)), Xn)
        X = jnp.where(act, Xn, X)
        p = p + jnp.sum(c, axis=0)
        ctx = jnp.where(act, symd, ctx)
        return X, p, ctx, symd.astype(jnp.uint8)

    if win in rans_v2._WIN_PARAMS:
        FC = rans_v2.FINE_CW
        NC2 = NC * (CHUNK // FC)
        chunks_f = chunks.reshape(B * NC2, FC)
        brange2 = jnp.arange(B, dtype=jnp.int32) * NC2

        def refill(p):
            c0 = jnp.minimum(p >> 4, NC2 - 1)
            cs = [brange2 + jnp.minimum(c0 + i, NC2 - 1)
                  for i in range(NROWS)]
            rows = jnp.stack(cs, axis=1).reshape(-1)
            return (jnp.take(chunks_f, rows, axis=0).reshape(B, W).T,
                    c0 << 4)
    else:
        brange = jnp.arange(B, dtype=jnp.int32) * NC

        def refill(p):
            c0 = jnp.minimum(p >> 7, NC - 1)
            c1 = jnp.minimum(c0 + 1, NC - 1)
            rows = jnp.stack([brange + c0, brange + c1],
                             axis=1).reshape(-1)
            return (jnp.take(chunks, rows,
                             axis=0).reshape(B, 2 * CHUNK).T,
                    c0 << 7)

    def outer(carry, ko):
        X, p, ctx = carry
        winT, base = refill(p)

        # winT/base are invariant within the inner scan: close over
        # them instead of carrying them.
        def body(carry, s):
            X, p, ctx = carry
            X, p, ctx, symd = one(X, p, ctx, s, winT, base)
            return (X, p, ctx), symd

        steps = ko * R + jnp.arange(R)
        (X, p, ctx), syms = lax.scan(body, (X, p, ctx), steps)
        return (X, p, ctx), syms

    p0 = jnp.zeros((B,), jnp.int32)
    ctx0 = jnp.zeros((4, B), jnp.int32)
    X0T = jnp.transpose(X0, (1, 0))
    (Xf, pf, _), syms = lax.scan(outer, (X0T, p0, ctx0),
                                 jnp.arange(KO, dtype=jnp.int32))
    return syms.reshape(KO * R, 4, B), Xf


@functools.partial(jax.jit, static_argnames=("K", "q", "N", "order",
                                             "win", "row_fetch"))
def _dec8_to_bytes(X0, chunks, packed, alpha, K: int, q: int, N: int,
                   order: int, win: str = "coarse",
                   row_fetch: str = "onehot"):
    syms, Xf = _dec_scan8(X0, chunks, packed, K, q, order, win,
                          row_fetch)
    B = X0.shape[0]
    out_t = rans_v2._undensify_T(syms[:K], alpha)           # (K,4,B)
    if order == 1:
        main = jnp.transpose(out_t[:q], (2, 1, 0)).reshape(B, 4 * q)
        if 4 * q >= N:
            return main[:, :N]
        tailp = jnp.transpose(out_t[q:, 3, :], (1, 0))      # (B,K-q)
        return jnp.concatenate([main, tailp[:, :N - 4 * q]], axis=1)
    # order 0: the final N & 3 symbols are read from the states
    # without advancing them (rANS_static.c:346-355)
    flat = jnp.transpose(out_t, (2, 0, 1)).reshape(B, K * 4)
    body = N & ~3
    if body == N:
        return flat[:, :N]
    mask = jnp.uint32((1 << SHIFT) - 1)
    m = (jnp.transpose(Xf, (1, 0)) & mask).astype(jnp.int32)  # (B, 4)
    base_r = packed >> PACK_SHIFT
    f_r = packed & PACK_MASK
    okm = (base_r[:, None, :] <= m[:, :, None]) & (f_r[:, None, :] > 0)
    iota = jnp.arange(packed.shape[1], dtype=jnp.int32)
    symd = jnp.max(jnp.where(okm, iota, 0), axis=2)
    tail_b = _undensify(symd, alpha)                   # (B, 4)
    return jnp.concatenate([flat[:, :body], tail_b[:, :N - body]], axis=1)


def _chunkify8(stream_bytes: np.ndarray) -> np.ndarray:
    """(B, W) u8 -> (B*NC, CHUNK) i32."""
    B, W = stream_bytes.shape
    NC = max(-(-W // CHUNK), 2)
    out = np.zeros((B, NC * CHUNK), np.int32)
    out[:, :W] = stream_bytes
    return out.reshape(B * NC, CHUNK)


def dec_o0_batch(states, stream, out_sz: int, alpha, packed):
    """states (B,4) u32; stream (B,W) u8 (bytes after the 16 state
    bytes); dense tables as in rans_v2.  Returns (B, out_sz) u8.

    out_sz < 4 would run a full 4-lane step before the no-advance tail
    symbols are read, corrupting the final states; such blocks belong
    on the host decoder (rANS_static.c:224-363 handles them there)."""
    if out_sz < 4:
        raise ValueError("dec_o0_batch requires out_sz >= 4; "
                         "route short blocks to the host decoder")
    q = out_sz >> 2
    K = max(q, 1)
    out = _dec8_to_bytes(
        jnp.asarray(states.astype(np.uint32)),
        jnp.asarray(_chunkify8(stream)),
        jnp.asarray(packed), jnp.asarray(alpha), K, K, out_sz, 0,
        win=rans_v2._DEC_VARIANT["win"])
    return np.asarray(out)


def dec_o1_batch(states, stream, out_sz: int, alpha, packed):
    q = out_sz >> 2
    K = q + (out_sz - 4 * q)
    out = _dec8_to_bytes(
        jnp.asarray(states.astype(np.uint32)),
        jnp.asarray(_chunkify8(stream)),
        jnp.asarray(packed), jnp.asarray(alpha), K, q, out_sz, 1,
        **rans_v2._DEC_VARIANT)
    return np.asarray(out)
