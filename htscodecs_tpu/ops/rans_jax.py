"""Batched rANS 4x16 engines, v1 (gather-based) — TEST ORACLE.

Superseded on every production path by the dense-alphabet v2 engines
(ops/rans_v2.py, ops/rans_gpu.py); wide alphabets (A > 96) route to
the native scalar coder.  This module is kept as an independent third implementation for the
engine x vector conformance matrix (tests/test_oracle_matrix.py,
tests/test_rans_jax.py).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

RANS_L = 1 << 15


# ---------------------------------------------------------------------------
# Order-0 encode

@functools.partial(jax.jit, static_argnames=("shift",))
def _enc_scan(starts, freqs, valid, shift: int):
    """Core reverse scan.

    starts/freqs/valid: (K, B, 4) per-step per-state coding params in
    PROCESSING order (step 0 is encoded first).  Returns final states
    (B, 4), words (K, B, 4) u32 and emit flags (K, B, 4) bool in
    processing order.
    """
    K, B, _ = starts.shape
    x0 = jnp.full((B, 4), RANS_L, dtype=jnp.uint32)

    xmax_mult = jnp.uint32((RANS_L >> shift) << 16)

    def step(x, inp):
        start, freq, ok = inp
        x_max = xmax_mult * freq
        emit = (x >= x_max) & ok
        word = x & jnp.uint32(0xFFFF)
        x2 = jnp.where(emit, x >> 16, x)
        q = x2 // jnp.where(ok, freq, jnp.uint32(1))
        newx = (q << shift) + (x2 - q * freq) + start
        x = jnp.where(ok, newx, x)
        return x, (word, emit)

    xf, (words, emits) = lax.scan(step, x0, (starts, freqs, valid))
    return xf, words, emits


@functools.partial(jax.jit, static_argnames=("shift", "cap"))
def _enc_compact(xf, words, emits, shift: int, cap: int):
    """Compact emitted words into forward-order streams.

    Emission processing order is step ascending with state 3 first;
    the stream is written backwards, so forward order is the reverse:
    step descending in processing order = ascending original order,
    states 0..3.  Returns (B, cap) u16 word buffer + (B,) counts.
    """
    K, B, _ = words.shape
    # processing order: (k, j=3..0).  Forward stream order is the exact
    # reverse: (K-1-k, j=0..3) ascending.
    w = words[::-1, :, ::-1]          # (K, B, 4) forward order
    e = emits[::-1, :, ::-1]
    w = jnp.transpose(w, (1, 0, 2)).reshape(B, -1)   # (B, K*4)
    e = jnp.transpose(e, (1, 0, 2)).reshape(B, -1)
    idx = jnp.cumsum(e, axis=1, dtype=jnp.int32) - 1
    n = idx[:, -1] + 1
    tgt = jnp.where(e, idx, cap)
    out = jnp.zeros((B, cap + 1), dtype=jnp.uint16)
    out = out.at[jnp.arange(B)[:, None], tgt].set(w.astype(jnp.uint16), mode="drop")
    return out[:, :cap], n


def enc_o0_batch(blocks: np.ndarray, start: np.ndarray, freq: np.ndarray,
                 shift: int = 12):
    """Batched order-0 payload encode.

    blocks: (B, N) uint8; start/freq: (B, 256) uint32 normalised tables.
    Returns (states (B,4) u32, words (B, cap) u16, counts (B,)) as
    numpy arrays; payload = states LE ++ words[:count] LE.
    """
    B, N = blocks.shape
    K = (N + 3) // 4
    pad = K * 4 - N

    syms = np.pad(blocks, ((0, 0), (0, pad)))
    # symbol i -> (step i>>2, state i&3); processing order = reverse i
    sy = syms.reshape(B, K, 4)
    valid = np.ones((B, K, 4), dtype=bool)
    if pad:
        valid[:, -1, 4 - pad:] = False

    b_idx = np.arange(B)[:, None, None]
    st = start[b_idx, sy].astype(np.uint32)
    fr = freq[b_idx, sy].astype(np.uint32)

    # processing order: steps reversed, states 3..0 within a step
    st_p = np.ascontiguousarray(np.transpose(st[:, ::-1, ::-1], (1, 0, 2)))
    fr_p = np.ascontiguousarray(np.transpose(fr[:, ::-1, ::-1], (1, 0, 2)))
    va_p = np.ascontiguousarray(np.transpose(valid[:, ::-1, ::-1], (1, 0, 2)))

    xf, words, emits = _enc_scan(jnp.asarray(st_p), jnp.asarray(fr_p),
                                 jnp.asarray(va_p), shift)
    cap = int(N + 16)  # worst case ~1 word per symbol / 4 states + slack
    out, n = _enc_compact(xf, words, emits, shift, cap)
    # scan lanes are in processing order (state 3 first); flip to 0..3
    return np.asarray(xf)[:, ::-1], np.asarray(out), np.asarray(n)


# ---------------------------------------------------------------------------
# Order-1 encode

def enc_o1_batch(blocks: np.ndarray, start2d: np.ndarray, freq2d: np.ndarray,
                 shift: int):
    """Batched order-1 payload encode.

    blocks: (B, N) uint8 with N >= 8; start2d/freq2d: (B, 256, 256).
    Handles the state-3 tail and the four context-0 quarter leaders.
    """
    B, N = blocks.shape
    q = N >> 2
    tail = N - 4 * q

    # Build (K, B, 4) param arrays in processing order:
    #  steps 0..tail-1: state-3-only tail (ctx=data[n-2-s], sym=data[n-1-s])
    #  steps tail..tail+q-2: main loop k=q-2..0: ctx=data[j*q+k], sym=data[j*q+k+1]
    #  final step: ctx=0, sym=data[j*q]
    K = tail + (q - 1) + 1
    ctx = np.zeros((K, B, 4), dtype=np.int32)
    sym = np.zeros((K, B, 4), dtype=np.int32)
    valid = np.zeros((K, B, 4), dtype=bool)

    for s in range(tail):
        i3 = N - 2 - s
        ctx[s, :, 3] = blocks[:, i3]
        sym[s, :, 3] = blocks[:, i3 + 1]
        valid[s, :, 3] = True

    if q >= 2:
        ks = np.arange(q - 2, -1, -1)
        # main block, processing order k=q-2..0:
        # ctx=data[j*q+k], sym=data[j*q+k+1]
        c = blocks[:, (ks[:, None] + np.arange(4)[None, :] * q)]       # (B, q-1, 4)
        l = blocks[:, (ks[:, None] + np.arange(4)[None, :] * q + 1)]
        ctx[tail:tail + q - 1] = np.transpose(c, (1, 0, 2))
        sym[tail:tail + q - 1] = np.transpose(l, (1, 0, 2))
        valid[tail:tail + q - 1] = True

    # final: syms[0][last] where last = data[j*q]
    ctx[K - 1, :, :] = 0
    sym[K - 1, :, :] = blocks[:, (np.arange(4) * q)]
    valid[K - 1, :, :] = True

    b_idx = np.arange(B)[None, :, None]
    st = start2d[b_idx, ctx, sym].astype(np.uint32)
    fr = freq2d[b_idx, ctx, sym].astype(np.uint32)
    # within-step processing order is state 3 first
    st_p = np.ascontiguousarray(st[:, :, ::-1])
    fr_p = np.ascontiguousarray(fr[:, :, ::-1])
    va_p = np.ascontiguousarray(valid[:, :, ::-1])

    xf, words, emits = _enc_scan(jnp.asarray(st_p), jnp.asarray(fr_p),
                                 jnp.asarray(va_p), shift)
    cap = int(N + 16)
    out, n = _enc_compact(xf, words, emits, shift, cap)
    # scan lanes are in processing order (state 3 first); flip to 0..3
    return np.asarray(xf)[:, ::-1], np.asarray(out), np.asarray(n)


# ---------------------------------------------------------------------------
# Order-0 decode

@functools.partial(jax.jit, static_argnames=("shift", "K"))
def _dec_o0_scan(X0, buf, p0, ssym, sfb, shift: int, K: int):
    """X0: (B,4) initial states; buf: (B,W) u32 word stream (u16 values);
    p0: (B,) initial word pointers; ssym: (B, 1<<shift) u8 symbols;
    sfb: (B, 1<<shift) u32 packed (freq<<16 | base).
    Returns symbols (K, B, 4) and final carry."""
    B = X0.shape[0]
    mask = jnp.uint32((1 << shift) - 1)
    W = buf.shape[1]

    def step(carry, _):
        X, p = carry
        m = X & mask
        sym = jnp.take_along_axis(ssym, m, axis=1)
        fb = jnp.take_along_axis(sfb, m, axis=1)
        f = fb >> 16
        b = fb & jnp.uint32(0xFFFF)
        X = f * (X >> shift) + b
        need = X < jnp.uint32(RANS_L)
        off = jnp.cumsum(need.astype(jnp.int32), axis=1) - need.astype(jnp.int32)
        src = jnp.minimum(p[:, None] + off, W - 1)
        w = jnp.take_along_axis(buf, src, axis=1)
        can = need & ((p[:, None] + off) < W)
        X = jnp.where(can, (X << 16) | w, X)
        p = p + jnp.sum(need.astype(jnp.int32) * can.astype(jnp.int32), axis=1)
        return (X, p), sym

    (Xf, pf), syms = lax.scan(step, (X0, p0), None, length=K)
    return syms, Xf, pf


def dec_o0_batch(states: np.ndarray, words: np.ndarray, out_sz: int,
                 ssym: np.ndarray, sfreq: np.ndarray, sbase: np.ndarray,
                 shift: int = 12) -> np.ndarray:
    """Batched order-0 payload decode.

    states: (B,4) u32; words: (B,W) u16 renorm stream; LUTs (B, 1<<shift).
    Returns (B, out_sz) uint8.
    """
    B = states.shape[0]
    K = (out_sz + 3) // 4
    sfb = (sfreq.astype(np.uint32) << 16) | sbase.astype(np.uint32)
    syms, _, _ = _dec_o0_scan(
        jnp.asarray(states.astype(np.uint32)),
        jnp.asarray(words.astype(np.uint32)),
        jnp.zeros((B,), dtype=jnp.int32),
        jnp.asarray(ssym.astype(np.uint32)),
        jnp.asarray(sfb),
        shift, K,
    )
    out = np.asarray(syms).astype(np.uint8)          # (K, B, 4)
    out = np.transpose(out, (1, 0, 2)).reshape(B, K * 4)
    return out[:, :out_sz]


# ---------------------------------------------------------------------------
# Order-1 decode

@functools.partial(jax.jit, static_argnames=("shift", "K", "q"))
def _dec_o1_scan(X0, buf, p0, sfb_flat, fbb_flat, shift: int, K: int, q: int):
    """sfb_flat: (B, 256<<shift) u8 symbol LUT (ctx*tot + slot);
    fbb_flat: (B, 65536) u32 packed (freq<<16 | base) per (ctx, sym).
    States 0-2 stop after q steps; state 3 runs K steps (tail)."""
    B = X0.shape[0]
    mask = jnp.uint32((1 << shift) - 1)
    tot = jnp.uint32(1 << shift)
    W = buf.shape[1]
    active_tail = jnp.array([False, False, False, True])

    def step(carry, s):
        X, p, ctx = carry
        act = jnp.where(s < q, jnp.ones((4,), bool), active_tail)[None, :]
        m = X & mask
        sym = jnp.take_along_axis(sfb_flat, ctx * tot + m, axis=1).astype(jnp.uint32)
        fb = jnp.take_along_axis(fbb_flat, (ctx << 8) | sym, axis=1)
        f = fb >> 16
        b = fb & jnp.uint32(0xFFFF)
        Xn = f * (X >> shift) + m - b
        need = (Xn < jnp.uint32(RANS_L)) & act
        off = jnp.cumsum(need.astype(jnp.int32), axis=1) - need.astype(jnp.int32)
        src = jnp.minimum(p[:, None] + off, W - 1)
        w = jnp.take_along_axis(buf, src, axis=1)
        can = need & ((p[:, None] + off) < W)
        Xn = jnp.where(can, (Xn << 16) | w, Xn)
        X = jnp.where(act, Xn, X)
        p = p + jnp.sum(need.astype(jnp.int32) * can.astype(jnp.int32), axis=1)
        ctx = jnp.where(act, sym, ctx)
        return (X, p, ctx), sym

    (Xf, pf, ctxf), syms = lax.scan(
        step, (X0, p0, jnp.zeros_like(X0)), jnp.arange(K))
    return syms, Xf, pf


def dec_o1_batch(states: np.ndarray, words: np.ndarray, out_sz: int,
                 sfb: np.ndarray, f2d: np.ndarray, b2d: np.ndarray,
                 shift: int) -> np.ndarray:
    """Batched order-1 payload decode.

    sfb: (B, 256, 1<<shift) u8 ctx-slot->symbol; f2d/b2d: (B, 256, 256).
    Returns (B, out_sz) uint8.
    """
    B = states.shape[0]
    q = out_sz >> 2
    tail = out_sz - 4 * q
    K = q + tail
    fbb = ((f2d.astype(np.uint32) << 16) | b2d.astype(np.uint32)).reshape(B, -1)
    syms, _, _ = _dec_o1_scan(
        jnp.asarray(states.astype(np.uint32)),
        jnp.asarray(words.astype(np.uint32)),
        jnp.zeros((B,), dtype=jnp.int32),
        jnp.asarray(sfb.reshape(B, -1)),
        jnp.asarray(fbb),
        shift, K, q,
    )
    s = np.asarray(syms).astype(np.uint8)        # (K, B, 4)
    out = np.empty((B, out_sz), dtype=np.uint8)
    main = np.transpose(s[:q], (1, 2, 0))        # (B, 4, q)
    out[:, :4 * q] = main.reshape(B, 4 * q)
    if tail:
        out[:, 4 * q:] = np.transpose(s[q:, :, 3], (1, 0))
    return out
