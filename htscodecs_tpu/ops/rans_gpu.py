"""rANS 4x16 decode and encode as one Pallas kernel (Triton route).

The XLA scans in ``ops/rans_v2.py`` run N/4 sequential steps per
64 KiB block, and on a GPU every scan step is its own kernel launch
that re-reads the per-block tables from device memory.  Here the whole
symbol loop runs inside one kernel launch per batch:

- one program decodes (or encodes) BPP = 8 blocks; its working tile is
  ``(8, 4)``, one element per interleaved rANS state, and the states
  stay in registers for the whole loop;
- the per-block tables are the cumulative-base rows of
  ``rans_v2._b16_fill`` (``(A_ctx, A+1)`` u16 per block, holes filled
  with the next valid base, last column ``1 << shift``).  They are read
  with gather loads that stay in the SM's L1 cache: at A = 96 a block's
  rows are 18.6 KB;
- decode finds slot -> symbol by a binary search over the context's
  row (at most 7 probes at A = 96); freq and base are two more loads;
- the renorm word claim is a 4-lane prefix sum in lane order 0..3,
  which is the order the format defines (``rANS_word.h``: each state
  reads ``*ptr++`` in turn);
- encode runs the same loop backwards and writes each emitted word at
  ``ptr - 1 - (words emitted by higher lanes this step)``, the order of
  the reference encoder (state 3 first, ``*--ptr``), so its output is
  already compacted; a gather after the kernel moves each block's word
  run to the front of its row.

State maths is the reference's (``rANS_word.h``; L = 1 << 15, 16-bit
renorm); the order-1 quarter layout and lane-3 tail follow
``rANS_static4x16pr.c:786-846`` (encode) and ``:1024-1114`` (decode).
The XLA scans stay as the CPU path and as the tests' reference; the
tests run this kernel in interpret mode against them and the native
coder.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

RANS_L = 1 << 15
# Blocks per program (a (8, 4) tile, one warp).  On an H100 this beat
# 2/4/16/32/64 within 15% at every width measured, and choosing it
# from B (bigger tiles for big batches) lost up to 27% on decode.
BPP = 8


def _pad_rows(x, Bp):
    """Pad the leading axis to Bp with copies of row 0 (outputs of the
    copies are sliced off)."""
    B = x.shape[0]
    if Bp == B:
        return x
    return jnp.concatenate(
        [x, jnp.broadcast_to(x[:1], (Bp - B,) + x.shape[1:])])


def _tables(packed, shiftv, order: int):
    """(B, A_ctx, A+1) u16 cumulative-base rows (A_ctx = 1 for O0)."""
    from . import rans_v2
    if order == 0:
        packed = packed[:, None, :]
    return rans_v2._b16_fill(packed, shiftv).astype(jnp.uint16)


def _probe_steps(A: int):
    p = 1
    while p < A:
        p *= 2
    steps = []
    while p > 1:
        p //= 2
        steps.append(p)
    return steps


def _call(kernel, out_shape, B: int, interpret: bool):
    return pl.pallas_call(
        kernel, out_shape=out_shape, grid=(B // BPP,), interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, BPP * 4 // 32), num_stages=1))


# ---------------------------------------------------------------------------
# decode

def _dec_kernel(x0_ref, sh_ref, words_ref, tbl_ref, alpha_ref, out_ref, *,
                A: int, K: int, q: int, W: int, order: int):
    b = pl.program_id(0) * BPP + lax.broadcasted_iota(
        jnp.int32, (BPP, 4), 0)
    lane = lax.broadcasted_iota(jnp.int32, (BPP, 4), 1)
    X0 = plgpu.load(x0_ref.at[b, lane])
    sh = plgpu.load(sh_ref.at[b]).astype(jnp.uint32)
    mask = (jnp.uint32(1) << sh) - jnp.uint32(1)
    steps = _probe_steps(A)

    def body(k, carry):
        X, p, ctx = carry
        m = (X & mask).astype(jnp.int32)
        s = jnp.zeros_like(lane)
        for st in steps:
            cand = s + st
            v = plgpu.load(tbl_ref.at[b, ctx, jnp.minimum(cand, A)])
            s = jnp.where(v.astype(jnp.int32) <= m, cand, s)
        base = plgpu.load(tbl_ref.at[b, ctx, s]).astype(jnp.int32)
        f = plgpu.load(tbl_ref.at[b, ctx, s + 1]).astype(jnp.int32) - base
        Xn = (f.astype(jnp.uint32) * (X >> sh)
              + (m - base).astype(jnp.uint32))
        if order == 1:
            act = (k < q) | (lane == 3)
            pos = lane * q + k
        else:
            act = jnp.full(lane.shape, True)
            pos = 4 * k + lane
        need = (Xn < jnp.uint32(RANS_L)) & act
        ni = need.astype(jnp.int32)
        off = p + jnp.cumsum(ni, axis=1) - ni
        w = plgpu.load(words_ref.at[b, jnp.minimum(off, W - 1)],
                       mask=need, other=0)
        Xn = jnp.where(need, (Xn << 16) | w.astype(jnp.uint32), Xn)
        sym = plgpu.load(alpha_ref.at[b, s])
        plgpu.store(out_ref.at[b, pos], sym, mask=act)
        X = jnp.where(act, Xn, X)
        ctx = jnp.where(act, s, ctx) if order == 1 else ctx
        p = p + jnp.sum(ni, axis=1, keepdims=True)
        return X, p, ctx

    carry = (X0, jnp.zeros((BPP, 1), jnp.int32), jnp.zeros_like(lane))
    lax.fori_loop(0, K, body, carry)


@functools.partial(jax.jit, static_argnames=("N", "order", "interpret"))
def dec(states, words, packed, alpha, shiftv, N: int, order: int,
        interpret: bool = False):
    """Decode a batch of rANS 4x16 payloads.

    states (B, 4) u32 initial states (lane 0..3); words (B, W) renorm
    words (u16 values, any int dtype); packed (B, A, A) order-1 or
    (B, A) order-0 ``(base << 13) | freq`` dense tables; alpha (B, A)
    u8 sorted alphabets; shiftv (B,) table precision.  Returns (B, N)
    u8 decoded blocks.
    """
    B = states.shape[0]
    A = alpha.shape[1]
    Bp = -(-B // BPP) * BPP
    if order == 1:
        q = N >> 2
        K = q + (N - 4 * q)
        NO = N
    else:
        q = K = -(-N // 4)
        NO = 4 * K
    tbl = _tables(packed, shiftv, order)
    args = [_pad_rows(a, Bp) for a in (
        states.astype(jnp.uint32), shiftv.astype(jnp.int32),
        words.astype(jnp.uint16), tbl, alpha.astype(jnp.uint8))]
    W = args[2].shape[1]
    kernel = functools.partial(_dec_kernel, A=A, K=K, q=q, W=W,
                               order=order)
    out = _call(kernel, jax.ShapeDtypeStruct((Bp, NO), jnp.uint8),
                Bp, interpret)(*args)
    return out[:B, :N]


# ---------------------------------------------------------------------------
# encode

def _enc_kernel(sh_ref, dense_ref, tbl_ref, x_ref, buf_ref, ptr_ref, *,
                K: int, q: int, N: int, C: int, order: int):
    b = pl.program_id(0) * BPP + lax.broadcasted_iota(
        jnp.int32, (BPP, 4), 0)
    lane = lax.broadcasted_iota(jnp.int32, (BPP, 4), 1)
    sh = plgpu.load(sh_ref.at[b]).astype(jnp.uint32)
    xmax_mult = (jnp.uint32(RANS_L) >> sh) << 16

    def body(t, carry):
        X, ptr = carry
        k = K - 1 - t
        if order == 1:
            pos = lane * q + k
            ok = (k < q) | (lane == 3)
            ctx = plgpu.load(dense_ref.at[b, jnp.maximum(pos - 1, 0)])
            ctx = jnp.where(k > 0, ctx.astype(jnp.int32), 0)
        else:
            pos = 4 * k + lane
            ok = pos < N
            ctx = jnp.zeros_like(lane)
        sym = plgpu.load(dense_ref.at[b, jnp.minimum(pos, N - 1)])
        sym = sym.astype(jnp.int32)
        start = plgpu.load(tbl_ref.at[b, ctx, sym]).astype(jnp.int32)
        freq = plgpu.load(tbl_ref.at[b, ctx, sym + 1]).astype(
            jnp.int32) - start
        freq = jnp.where(ok, freq, 1).astype(jnp.uint32)
        emit = (X >= xmax_mult * freq) & ok
        ei = emit.astype(jnp.int32)
        tot = jnp.sum(ei, axis=1, keepdims=True)
        # state 3 writes first (*--ptr), then 2, 1, 0; lanes that do not
        # emit aim below every position this step writes
        wpos = jnp.where(emit, ptr - 1 - tot + jnp.cumsum(ei, axis=1),
                         ptr - tot - 1 - lane)
        plgpu.store(buf_ref.at[b, wpos],
                    (X & jnp.uint32(0xFFFF)).astype(jnp.uint16), mask=emit)
        x2 = jnp.where(emit, X >> 16, X)
        qq = x2 // freq
        Xn = (qq << sh) + (x2 - qq * freq) + start.astype(jnp.uint32)
        return jnp.where(ok, Xn, X), ptr - tot

    X0 = jnp.full((BPP, 4), RANS_L, jnp.uint32)
    X, ptr = lax.fori_loop(0, K, body,
                           (X0, jnp.full((BPP, 1), C, jnp.int32)))
    plgpu.store(x_ref.at[b, lane], X)
    b1 = pl.program_id(0) * BPP + lax.broadcasted_iota(
        jnp.int32, (BPP, 1), 0)
    plgpu.store(ptr_ref.at[b1, jnp.zeros_like(b1)], ptr)


@functools.partial(jax.jit, static_argnames=("order", "interpret"))
def enc(blocks, alpha, packed, shiftv, order: int, interpret: bool = False):
    """Encode a batch of equal-length blocks with dense tables.

    blocks (B, N) u8; alpha (B, A) u8; packed (B, A, A) or (B, A) i32;
    shiftv (B,) table precision.  Returns (states (B, 4) u32 lane 0..3,
    words (B, C) u16 with each block's words at the front, counts (B,)
    i32), the layout of ``rans_v2._enc_scan_v2`` without its overflow
    flag.
    """
    from . import rans_v2
    B, N = blocks.shape
    Bp = -(-B // BPP) * BPP
    if order == 1:
        q = N >> 2
        K = q + (N - 4 * q)
    else:
        q = K = -(-N // 4)
    # at most one word per symbol; 4 spare slots keep the parking
    # positions of non-emitting lanes (ptr - tot - 1 - lane) in range
    C = 4 * K + 4
    dense = rans_v2._densify(blocks, alpha).astype(jnp.uint8)
    tbl = _tables(packed, shiftv, order)
    args = [_pad_rows(a, Bp) for a in (shiftv.astype(jnp.int32), dense,
                                       tbl)]
    kernel = functools.partial(_enc_kernel, K=K, q=q, N=N, C=C,
                               order=order)
    X, buf, ptr = _call(
        kernel,
        (jax.ShapeDtypeStruct((Bp, 4), jnp.uint32),
         jax.ShapeDtypeStruct((Bp, C), jnp.uint16),
         jax.ShapeDtypeStruct((Bp, 1), jnp.int32)),
        Bp, interpret)(*args)
    X, buf, ptr = X[:B], buf[:B], ptr[:B, 0]
    idx = jnp.minimum(ptr[:, None] + jnp.arange(C, dtype=jnp.int32), C - 1)
    words = jnp.take_along_axis(buf, idx, axis=1)
    return X, words, C - ptr
