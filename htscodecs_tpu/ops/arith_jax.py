"""Batched adaptive range-coder engines (JAX/XLA scans).

The arith_dynamic codec is a strictly sequential adaptive coder
(reference: htscodecs/c_range_coder.h:46-127 and
htscodecs/c_simple_model.h:85-179): every byte updates the model the
next byte is coded with, so there is no intra-block parallelism.  The
formulation therefore batches B independent blocks and advances one
byte of every block per scan sub-step, with all model operations
expressed as fused elementwise passes over the model's M-entry tables:

- symbol search / cumulative frequency: compare + masked sums over M
  (the C linear scan's *result*, reproduced exactly — position, cum
  and freq are order-identical, so streams match byte for byte);
- the +STEP update, the MAX_FREQ halving normalisation and the
  one-step bubble swap: masked elementwise selects (zero-freq entries
  sit beyond position m-1 forever, so the C "break at first zero" is
  equivalent to a freq>0 mask);
- the carry-counting emission (cache + 0xFF-run deferral) emits at
  most two events per byte, each packed as (ffnum<<9 | ffbyte_bit<<8
  | byte); events are compacted with the same two-level sort used by
  the rANS engines and expanded to the byte stream on the host (the
  ff-run expansion is a handful of np.repeat calls);
- decode consumes at most two stream bytes per symbol through the
  chunk-aligned carry window + jnp.take row refill machinery.

Model size M is the padded max-symbol of the batch (the C model is
NSYM=256 wide, but entries past max_sym keep frequency 0 and by
induction never move into the active prefix, so only M entries exist
on device).  The scan body is unrolled U bytes per step to amortise
the per-step XLA loop overhead.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import rans_v2

TOP = 1 << 24
THRES = 0xFF000000
M32 = 0xFFFFFFFF
MAX_FREQ = (1 << 16) - 17
STEP = 16

UNROLL = 4           # bytes coded per scan step
CHUNK = 128          # decode window refill chunk (bytes)
DR = 16              # decode inner steps per refill: 2*UNROLL*DR + 127 <= 255
MAX_DENSE_M = 96     # fall back to host above this max-symbol


def _round_m(m: int) -> int:
    for cand in (4, 8, 16, 24, 32, 48, 64, 96):
        if m <= cand:
            return cand
    return m


# ---------------------------------------------------------------------------
# model primitives (shared by encode and decode)

def _search_by_symbol(syms, freqs, sym):
    """Encode-side linear search: returns (p, acc, f)."""
    match = syms == sym[:, None]
    before = jnp.cumsum(match.astype(jnp.int32), axis=1) == 0
    acc = jnp.sum(jnp.where(before, freqs, 0), axis=1)
    f = jnp.sum(jnp.where(match, freqs, 0), axis=1)
    p = jnp.sum(before.astype(jnp.int32), axis=1)
    return p, acc, f


def _search_by_freq(syms, freqs, target):
    """Decode-side search: smallest p with cum[p] > target (walking
    past zero-freq entries exactly like the C loop).
    Returns (p, sym, acc=cum[p]-f[p], f)."""
    cum = jnp.cumsum(freqs, axis=1)
    le = cum <= target[:, None]
    p = jnp.sum(le.astype(jnp.int32), axis=1)
    M = freqs.shape[1]
    at_p = jnp.arange(M, dtype=jnp.int32)[None, :] == p[:, None]
    f = jnp.sum(jnp.where(at_p, freqs, 0), axis=1)
    sym = jnp.sum(jnp.where(at_p, syms.astype(jnp.int32), 0), axis=1)
    acc = jnp.sum(jnp.where(le, freqs, 0), axis=1)  # freqs[0..p-1]
    return p, sym, acc, f


def _model_update(syms, freqs, total, p, active):
    """freqs[p] += STEP; halve-normalise when total > MAX_FREQ; one
    bubble-swap step.  `active` masks finished blocks."""
    M = freqs.shape[1]
    iota = jnp.arange(M, dtype=jnp.int32)[None, :]
    at_p = (iota == p[:, None]) & active[:, None]
    freqs = freqs + at_p.astype(freqs.dtype) * STEP
    total = total + active.astype(total.dtype) * STEP

    do_norm = (total > MAX_FREQ) & active
    halved = freqs - (freqs >> 1)
    freqs = jnp.where(do_norm[:, None] & (freqs > 0), halved, freqs)
    total = jnp.where(do_norm, jnp.sum(freqs, axis=1), total)

    at_prev = (iota == (p - 1)[:, None])
    f_at = jnp.sum(jnp.where(at_p, freqs, 0), axis=1)
    f_prev = jnp.sum(jnp.where(at_prev & active[:, None], freqs, 0), axis=1)
    s_at = jnp.sum(jnp.where(at_p, syms.astype(jnp.int32), 0), axis=1)
    s_prev = jnp.sum(jnp.where(at_prev & active[:, None],
                               syms.astype(jnp.int32), 0), axis=1)
    do_swap = ((p > 0) & (f_at > f_prev) & active)[:, None]
    freqs = jnp.where(do_swap & at_p, f_prev[:, None],
                      jnp.where(do_swap & at_prev, f_at[:, None], freqs))
    syms = jnp.where(do_swap & at_p, s_prev[:, None].astype(syms.dtype),
                     jnp.where(do_swap & at_prev,
                               s_at[:, None].astype(syms.dtype), syms))
    return syms, freqs, total


# ---------------------------------------------------------------------------
# encode

def _shift_low(low, cache, ffnum, carry):
    """One RC_ShiftLow: returns (new state..., event u32, flush flag).
    Event packs (ffnum << 9) | (ffbyte_is_00 << 8) | byte."""
    flush = (low < jnp.uint32(THRES)) | (carry != 0)
    byte1 = (cache + carry) & jnp.uint32(0xFF)
    ffb00 = (carry > 0).astype(jnp.uint32)
    evt = (ffnum.astype(jnp.uint32) << 9) | (ffb00 << 8) | byte1
    cache = jnp.where(flush, low >> 24, cache)
    ffnum = jnp.where(flush, jnp.uint32(0), ffnum + 1)
    carry = jnp.where(flush, jnp.uint32(0), carry)
    low = (low << 8) & jnp.uint32(M32)
    return low, cache, ffnum, carry, evt, flush


def _enc_one(carry_state, sym, active):
    """Code one byte in every block.  Returns events (B, 2) u32 and
    flush flags (B, 2)."""
    syms, freqs, total, low, rng, cache, ffnum, rc_carry, csat = carry_state
    p, acc, f = _search_by_symbol(syms, freqs, sym)
    # RC_Encode
    r = rng // jnp.maximum(total, 1).astype(jnp.uint32)
    add = acc.astype(jnp.uint32) * r
    new_low = (low + add) & jnp.uint32(M32)
    wrap = new_low < low
    rc_carry = rc_carry + (wrap & active).astype(jnp.uint32)
    csat = csat | (rc_carry > 1)
    rng2 = r * jnp.maximum(f, 1).astype(jnp.uint32)
    low = jnp.where(active, new_low, low)
    rng = jnp.where(active, rng2, rng)

    evs = []
    fls = []
    for _ in range(2):
        need = (rng < jnp.uint32(TOP)) & active
        nlow, ncache, nffnum, ncarry, evt, flush = _shift_low(
            low, cache, ffnum, rc_carry)
        low = jnp.where(need, nlow, low)
        cache = jnp.where(need, ncache, cache)
        ffnum = jnp.where(need, nffnum, ffnum)
        rc_carry = jnp.where(need, ncarry, rc_carry)
        rng = jnp.where(need, rng << 8, rng)
        evs.append(jnp.where(need & flush, evt, jnp.uint32(0)))
        fls.append(need & flush)

    syms, freqs, total = _model_update(syms, freqs, total, p, active)
    st = (syms, freqs, total, low, rng, cache, ffnum, rc_carry, csat)
    return st, jnp.stack(evs, axis=1), jnp.stack(fls, axis=1)


@functools.partial(jax.jit, static_argnames=("order", "seg_cap"))
def _enc_scan(blocks, lens, freqs0, order: int,
              seg_cap: int = rans_v2.SEG_CAP):
    """blocks (B, N) u8 (padded), lens (B,) i32, freqs0 (B, M) i32 for
    order 0 or (B, M, M) for order 1 (context-major).

    Returns (events (B, 2N) u32 compacted forward, event counts (B,),
    final RC state tuple, overflow flag)."""
    B, N = blocks.shape
    if order == 1:
        M = freqs0.shape[2]
    else:
        M = freqs0.shape[1]
    K = -(-N // UNROLL)
    pad = K * UNROLL - N
    data = jnp.pad(blocks, ((0, 0), (0, pad))).astype(jnp.int32)
    xs = jnp.transpose(data.reshape(B, K, UNROLL), (1, 0, 2))

    syms0 = jnp.broadcast_to(jnp.arange(M, dtype=jnp.uint8)[None, :], (B, M))
    if order == 1:
        syms0 = jnp.broadcast_to(
            jnp.arange(M, dtype=jnp.uint8)[None, None, :], (B, M, M))
    rc0 = (jnp.zeros((B,), jnp.uint32), jnp.full((B,), M32, jnp.uint32),
           jnp.zeros((B,), jnp.uint32), jnp.zeros((B,), jnp.uint32),
           jnp.zeros((B,), jnp.uint32), jnp.zeros((B,), bool))
    iotaM = jnp.arange(M, dtype=jnp.int32)

    def step(carry, inp):
        k, bytes_k = inp
        if order == 1:
            mstate, ctx, low, rng, cache, ffnum, rcc, csat = carry
            msyms, mfreqs, mtotal = mstate
        else:
            syms, freqs, total, low, rng, cache, ffnum, rcc, csat = carry
        evs, fls = [], []
        for u in range(UNROLL):
            i = k * UNROLL + u
            active = i < lens
            sym = bytes_k[:, u]
            if order == 1:
                # fetch the ctx row of the per-context model bank
                oh = (ctx[:, None] == iotaM)[:, :, None]
                syms = jnp.sum(jnp.where(oh, msyms, 0),
                               axis=1).astype(jnp.uint8)
                freqs = jnp.sum(jnp.where(oh, mfreqs, 0), axis=1)
                total = jnp.sum(jnp.where(ctx[:, None] == iotaM[None, :],
                                          mtotal, 0), axis=1)
            st, ev, fl = _enc_one(
                (syms, freqs, total, low, rng, cache, ffnum, rcc, csat),
                sym, active)
            syms, freqs, total, low, rng, cache, ffnum, rcc, csat = st
            if order == 1:
                # write the row back
                ohm = (ctx[:, None] == iotaM)[:, :, None] & active[:, None, None]
                msyms = jnp.where(ohm, syms[:, None, :], msyms)
                mfreqs = jnp.where(ohm, freqs[:, None, :], mfreqs)
                mtotal = jnp.where((ctx[:, None] == iotaM[None, :])
                                   & active[:, None], total[:, None], mtotal)
                ctx = jnp.where(active, sym, ctx)
            evs.append(ev)
            fls.append(fl)
        if order == 1:
            ncarry = ((msyms, mfreqs, mtotal), ctx, low, rng, cache, ffnum,
                      rcc, csat)
        else:
            ncarry = (syms, freqs, total, low, rng, cache, ffnum, rcc, csat)
        return ncarry, (jnp.stack(evs, axis=1), jnp.stack(fls, axis=1))

    if order == 1:
        ctx0 = jnp.zeros((B,), jnp.int32)
        total0 = jnp.sum(freqs0, axis=2)
        carry0 = ((syms0, freqs0, total0), ctx0) + rc0
    else:
        total0 = jnp.sum(freqs0, axis=1)
        carry0 = (syms0, freqs0, total0) + rc0

    carry, (events, flags) = lax.scan(
        step, carry0,
        (jnp.arange(K, dtype=jnp.int32), xs))
    # events: (K, B, U, 2) -> forward order (B, K*U*2)
    ev = jnp.transpose(events, (1, 0, 2, 3)).reshape(B, K * UNROLL * 2)
    fl = jnp.transpose(flags, (1, 0, 2, 3)).reshape(B, K * UNROLL * 2)
    ev, fl = lax.optimization_barrier((ev, fl))
    out, n, ovf = _compact_u32(ev, fl, seg_cap)
    if order == 1:
        _m, _c, low, rng, cache, ffnum, rcc, csat = carry
    else:
        _s, _f, _t, low, rng, cache, ffnum, rcc, csat = carry
    ovf = ovf | jnp.any(csat)
    return out, n, (low, rng, cache, ffnum, rcc), ovf


def _compact_u32(w, e, CAP):
    """Two-level compaction for u32 events (cf. rans_v2._compact)."""
    SEG = rans_v2.SEG
    B, E = w.shape
    KO = -(-E // SEG)
    pad = KO * SEG - E
    if pad:
        w = jnp.pad(w, ((0, 0), (0, pad)))
        e = jnp.pad(e, ((0, 0), (0, pad)))
    ws = w.reshape(B * KO, SEG)
    es = e.reshape(B * KO, SEG)
    loc = jnp.cumsum(es.astype(jnp.int32), axis=1)
    keys = jnp.where(es, loc - 1, jnp.int32(SEG + 1))
    _, sw = lax.sort([keys, ws.astype(jnp.int32)], dimension=1, num_keys=1)
    cnt = loc[:, -1]
    overflow = jnp.any(cnt > CAP)
    cnt2 = cnt.reshape(B, KO)
    offs = jnp.cumsum(cnt2, axis=1) - cnt2
    n = cnt2.sum(axis=1)
    swc = sw[:, :CAP].reshape(B, KO * CAP)
    j = jnp.arange(CAP, dtype=jnp.int32)[None, None, :]
    gkey = jnp.where(j < cnt2[:, :, None], offs[:, :, None] + j,
                     jnp.int32(1 << 30)).reshape(B, KO * CAP)
    _, out = lax.sort([gkey, swc], dimension=1, num_keys=1)
    return out.astype(jnp.uint32), n, overflow


def _expand_events(evt: np.ndarray, rc_tail: bytes) -> bytes:
    """Host-side event expansion: each event is byte1 preceded-by an
    ffnum-run of the deferred placeholder byte... (emitted as byte1
    then the run, matching RangeEncoder._shift_low)."""
    if len(evt) == 0:
        return rc_tail
    b1 = (evt & 0xFF).astype(np.uint8)
    ffb = np.where(evt & 0x100, 0, 0xFF).astype(np.uint8)
    ffn = (evt >> 9).astype(np.int64)
    if not ffn.any():
        return b1.tobytes() + rc_tail
    reps = 1 + ffn
    total = int(reps.sum())
    out = np.empty(total, np.uint8)
    # byte1 first, then the run (order per RangeEncoder._shift_low)
    ends = np.cumsum(reps)
    starts = ends - reps
    out[starts] = b1
    fill = np.ones(total, np.uint8)
    fill[starts] = 0
    run_vals = np.repeat(ffb, reps)
    out = np.where(fill, run_vals, out).astype(np.uint8)
    return out.tobytes() + rc_tail


def _finish_rc(low, rng, cache, ffnum, carry) -> bytes:
    """Replay the 5 flush shifts on host for one block."""
    out = bytearray()
    low = int(low)
    cache = int(cache)
    ffnum = int(ffnum)
    carry = int(carry)
    for _ in range(5):
        if low < THRES or carry:
            out.append((cache + carry) & 0xFF)
            if ffnum:
                out.extend([(carry - 1) & 0xFF] * ffnum)
                ffnum = 0
            cache = low >> 24
            carry = 0
        else:
            ffnum += 1
        low = (low << 8) & M32
    return bytes(out)


def enc_batch(blocks: np.ndarray, lens: np.ndarray, max_syms: np.ndarray,
              order: int):
    """Batched adaptive encode.  blocks (B, N) u8 padded; lens (B,);
    max_syms (B,) = per-block max_sym+1 (the first payload byte).
    Returns list of B payload byte strings (without the max byte), or
    None if the batch needs the host path."""
    B, N = blocks.shape
    m_max = int(max_syms.max())
    if m_max > MAX_DENSE_M:
        return None
    M = _round_m(m_max)
    iota = np.arange(M)
    f0 = (iota[None, :] < max_syms[:, None]).astype(np.int32)
    if order == 1:
        f0 = np.repeat(f0[:, None, :], M, axis=1)
    jb = jnp.asarray(blocks)
    jl = jnp.asarray(lens.astype(np.int32))
    jf = jnp.asarray(f0)
    out, n, rc, ovf = _enc_scan(jb, jl, jf, order)
    if bool(np.asarray(ovf)):
        # segment overflow (dense emission): exact single-sort path
        out, n, rc, ovf = _enc_scan(jb, jl, jf, order,
                                    seg_cap=rans_v2.SEG)
        if bool(np.asarray(ovf)):
            return None        # carry saturation: host path
    out = np.asarray(out)
    n = np.asarray(n)
    low, rng, cache, ffnum, carry = (np.asarray(x) for x in rc)
    res = []
    for b in range(B):
        tail = _finish_rc(low[b], rng[b], cache[b], ffnum[b], carry[b])
        body = _expand_events(out[b, :n[b]], tail)
        # the first emitted byte is the initial zero cache: it is
        # produced by the first flush event (cache=0) already
        res.append(body)
    return res


# ---------------------------------------------------------------------------
# decode

@functools.partial(jax.jit, static_argnames=("order", "K"))
def _dec_scan(chunks, code0, pos0, lens, freqs0, order: int, K: int):
    """chunks (B*NC, CHUNK) i32 byte stream; code0 (B,) u32 primed
    5-byte code; pos0 (B,) i32 stream positions; K = padded max len.
    Returns symbols (K, B) u8."""
    NC = chunks.shape[0] // (lens.shape[0])
    B = lens.shape[0]
    if order == 1:
        M = freqs0.shape[2]
    else:
        M = freqs0.shape[1]
    syms0 = jnp.broadcast_to(jnp.arange(M, dtype=jnp.uint8)[None, :], (B, M))
    if order == 1:
        syms0 = jnp.broadcast_to(
            jnp.arange(M, dtype=jnp.uint8)[None, None, :], (B, M, M))
    iotaM = jnp.arange(M, dtype=jnp.int32)
    brange = jnp.arange(B, dtype=jnp.int32) * NC
    KO = -(-K // (DR * UNROLL))
    R = DR

    iotaW = jnp.arange(2 * CHUNK, dtype=jnp.int32)[None, None, :]

    def get_byte(win, base, pos, take):
        off = jnp.where(take, pos - base, 2 * CHUNK)
        sel = off[:, None] == iotaW[0]
        return jnp.sum(jnp.where(sel, win, 0), axis=1).astype(jnp.uint32)

    def dec_one(carry, i, win, base):
        if order == 1:
            mstate, ctx, code, rng, pos = carry
            msyms, mfreqs, mtotal = mstate
            oh = (ctx[:, None] == iotaM)[:, :, None]
            syms = jnp.sum(jnp.where(oh, msyms, 0), axis=1).astype(jnp.uint8)
            freqs = jnp.sum(jnp.where(oh, mfreqs, 0), axis=1)
            total = jnp.sum(jnp.where(ctx[:, None] == iotaM[None, :],
                                      mtotal, 0), axis=1)
        else:
            syms, freqs, total, code, rng, pos = carry
        active = i < lens
        tot = jnp.maximum(total, 1).astype(jnp.uint32)
        ok = rng >= tot
        r = jnp.where(ok, rng // tot, rng)
        target = jnp.where(ok, code // jnp.maximum(r, 1), jnp.uint32(0))
        target = jnp.minimum(target, jnp.uint32(0xFFFF))
        p, sym, acc, f = _search_by_freq(syms, freqs,
                                         target.astype(jnp.int32))
        code2 = (code - acc.astype(jnp.uint32) * r) & jnp.uint32(M32)
        rng2 = r * jnp.maximum(f, 1).astype(jnp.uint32)
        code = jnp.where(active, code2, code)
        rng = jnp.where(active, rng2, rng)
        for _ in range(2):
            need = (rng < jnp.uint32(TOP)) & active
            byte = get_byte(win, base, pos, need)
            code = jnp.where(need, ((code << 8) | byte) & jnp.uint32(M32),
                             code)
            pos = pos + need.astype(jnp.int32)
            rng = jnp.where(need, rng << 8, rng)
        syms, freqs, total = _model_update(syms, freqs, total, p, active)
        if order == 1:
            ohm = (ctx[:, None] == iotaM)[:, :, None] & active[:, None, None]
            msyms = jnp.where(ohm, syms[:, None, :], msyms)
            mfreqs = jnp.where(ohm, freqs[:, None, :], mfreqs)
            mtotal = jnp.where((ctx[:, None] == iotaM[None, :])
                               & active[:, None], total[:, None], mtotal)
            ctx = jnp.where(active, sym, ctx)
            return ((msyms, mfreqs, mtotal), ctx, code, rng, pos), sym
        return (syms, freqs, total, code, rng, pos), sym

    def inner(carry, si, win, base):
        outs = []
        for u in range(UNROLL):
            carry, sym = dec_one(carry, si * UNROLL + u, win, base)
            outs.append(sym)
        return carry, jnp.stack(outs, axis=1)          # (B, U)

    def outer(carry, ko):
        pos = carry[-1]
        c0 = jnp.minimum(pos >> 7, NC - 1)
        c1 = jnp.minimum(c0 + 1, NC - 1)
        rows = jnp.stack([brange + c0, brange + c1], axis=1).reshape(-1)
        win = jnp.take(chunks, rows, axis=0).reshape(B, 2 * CHUNK)
        base = (c0 << 7)

        def mid(c, s):
            return inner(c, s, win, base)
        carry, symsU = lax.scan(
            mid, carry, ko * R + jnp.arange(R, dtype=jnp.int32))
        return carry, symsU                            # (R, B, U)

    if order == 1:
        total0 = jnp.sum(freqs0, axis=2)
        carry0 = ((syms0, freqs0, total0), jnp.zeros((B,), jnp.int32),
                  code0, jnp.full((B,), M32, jnp.uint32), pos0)
    else:
        total0 = jnp.sum(freqs0, axis=1)
        carry0 = (syms0, freqs0, total0, code0,
                  jnp.full((B,), M32, jnp.uint32), pos0)

    carry, syms = lax.scan(outer, carry0, jnp.arange(KO, dtype=jnp.int32))
    # (KO, R, B, U) -> (B, KO*R*U)
    out = jnp.transpose(syms, (2, 0, 1, 3)).reshape(B, KO * R * UNROLL)
    return out.astype(jnp.uint8)


def dec_batch(streams, out_sizes, max_syms, order: int):
    """Batched adaptive decode.  streams: list of payload byte strings
    (starting at the range-coded data, max byte already consumed);
    out_sizes, max_syms: per-block ints.  Returns (B, max_out) u8 (each
    row valid to its out_size) or None for host fallback."""
    B = len(streams)
    m_max = int(max(max_syms))
    if m_max > MAX_DENSE_M:
        return None
    M = _round_m(m_max)
    K = int(max(out_sizes))
    lens = np.asarray(out_sizes, np.int32)
    W = max(max(len(s) for s in streams), 8)
    NC = max(-(-W // CHUNK), 2)
    buf = np.zeros((B, NC * CHUNK), np.int32)
    code0 = np.zeros(B, np.uint32)
    pos0 = np.full(B, 5, np.int32)
    for b, s in enumerate(streams):
        a = np.frombuffer(s, np.uint8)
        buf[b, :len(a)] = a
        if len(a) >= 6:      # RangeDecoder: pos + 5 >= end refuses
            c = 0
            for j in range(5):
                c = ((c << 8) | int(a[j])) & 0xFFFFFFFFFF
            code0[b] = c & M32
        else:
            lens[b] = 0          # reference refuses to decode
    iota = np.arange(M)
    f0 = (iota[None, :] < np.asarray(max_syms)[:, None]).astype(np.int32)
    if order == 1:
        f0 = np.repeat(f0[:, None, :], M, axis=1)
    out = _dec_scan(jnp.asarray(buf.reshape(B * NC, CHUNK)),
                    jnp.asarray(code0), jnp.asarray(pos0),
                    jnp.asarray(lens), jnp.asarray(f0), order,
                    -(-K // (DR * UNROLL)) * DR * UNROLL)
    return np.asarray(out)[:, :K]
