"""Batched block codec API.

Compresses/decompresses many independent CRAM blocks at once, routing
the entropy payload work to the batched device engines (ops/rans_v2.py:
the Pallas kernel of ops/rans_gpu.py on a GPU, the XLA scans
elsewhere; dense alphabets A <= 96, wider alphabets go to the native
scalar coder) when a group is large enough, and to the native host
kernels otherwise.
Streams are byte-identical to `rans4x16.compress` / the C reference in
every path.

Batching rules: blocks group by (length, order[, table precision]) —
the scans are shape-specialised.  Transform-flagged streams
(PACK/RLE/CAT/NOSZ, STRIPE containers) are peeled host-side on decode
and their entropy payloads — including every stripe lane — join the
same batched device groups as plain streams.  Transform-flagged
ENCODE applies the transforms host-side, then DEFERS each candidate
entropy payload (including per-lane stripe method-search candidates)
into the same device groups; see compress_grouped/_encode_deferred
and tests/test_batch_transform_encode.py.
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import rans4x16
from .. import native
from ..utils import varint

# Below this many blocks in a shape group, the host path wins (device
# dispatch latency + staging dominate tiny batches).
DEVICE_MIN_GROUP = 16
# "auto" also requires this many payload bytes in a group before the
# device path engages (export HTSCODECS_TPU_DEVICE_MIN_BYTES to
# retune).
DEVICE_MIN_BYTES = int(__import__("os").environ.get(
    "HTSCODECS_TPU_DEVICE_MIN_BYTES", 4 << 20))

# Host table construction is native C via ctypes (GIL released), so a
# thread pool scales it across cores.
_POOL = ThreadPoolExecutor(max_workers=min(16, (__import__("os").cpu_count() or 4)))


def _pmap(fn, items):
    if len(items) <= 2:
        return [fn(x) for x in items]
    return list(_POOL.map(fn, items))


def _as_u8(b) -> np.ndarray:
    if isinstance(b, np.ndarray):
        return b.astype(np.uint8, copy=False)
    return np.frombuffer(bytes(b), dtype=np.uint8)


def compress_blocks(blocks, order: int, engine: str = "auto",
                    bodies_fn=None) -> list[bytes]:
    """Compress a sequence of blocks with the rANS 4x16 codec.

    Any reference order bit-field is accepted: plain 0/1 batches
    directly; transform-flagged orders (PACK/RLE/NOSZ, STRIPE
    containers) peel their transforms host-side and defer every
    entropy payload — including all STRIPE per-lane method-search
    candidates (reference rANS_static4x16pr.c:1190-1213) — into the
    same batched device groups.  Streams are byte-identical to
    `rans4x16.compress` in every path.

    engine: "auto" | "device" | "host".
    bodies_fn: optional entropy-body producer ``(batch (B,N) u8,
    order01) -> list[bytes] | None`` — the sharded layer
    (parallel/distributed.py) injects a shard_map engine here so
    ragged and transform-flagged batches reuse this exact peel/group
    machinery over a device mesh.
    """
    arrs = [_as_u8(b) for b in blocks]
    out: list[bytes | None] = [None] * len(arrs)

    plain_order = order in (0, 1)
    if not plain_order and engine != "host":
        return _compress_blocks_transform(arrs, order, engine, bodies_fn)
    groups: dict[int, list[int]] = defaultdict(list)
    for i, a in enumerate(arrs):
        if plain_order and engine != "host" and len(a) >= 32:
            groups[len(a)].append(i)
        else:
            out[i] = rans4x16.compress(a, order)

    for n, idxs in groups.items():
        if engine != "device" and (len(idxs) < DEVICE_MIN_GROUP
                                   or len(idxs) * n < DEVICE_MIN_BYTES):
            for i in idxs:
                out[i] = rans4x16.compress(arrs[i], order)
            continue
        batch = np.stack([arrs[i] for i in idxs])
        bodies = bodies_fn(batch, order) if bodies_fn is not None else None
        if bodies is not None:
            streams = [_frame(order, n, body, batch[k])
                       for k, body in enumerate(bodies)]
        else:
            streams = (_compress_batch_o1(batch) if order == 1
                       else _compress_batch_o0(batch))
        for i, s in zip(idxs, streams):
            out[i] = s

    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------
# transform-flagged encode: peel host-side, batch entropy on device

def _defer_entropy(jobs: list, data: np.ndarray, order01: int) -> int:
    jid = len(jobs)
    jobs.append((data, order01))
    return jid


def _finish(cand, res):
    return cand[1] if cand[0] == "done" else cand[1](res)


def _peel_encode(data: np.ndarray, order: int, jobs: list):
    """Mirror of rans4x16.compress with the entropy stages deferred.

    Returns ("done", bytes) or ("fin", callable(res) -> bytes|None)
    where res maps job ids to entropy body bytes (None body -> the
    caller falls back to the host encoder for the whole block)."""
    in_size = len(data)
    if in_size <= 20:
        order &= ~rans4x16.X_STRIPE

    if order & rans4x16.X_STRIPE:
        N = order >> 8
        if N == 0:
            N = 4
        if N > 255:
            raise ValueError("stripe N too large")
        head = bytearray()
        head.append(order & ~rans4x16.X_NOSZ & 0xFF)
        varint.put_uint(head, in_size)
        head.append(N)
        lane_cands = []
        for j in range(N):
            lane = data[j::N]
            methods = [m for m in (1, 64, 128, 0) if (order & m) == m]
            lane_cands.append(
                [_peel_encode(lane, m | rans4x16.X_NOSZ, jobs)
                 for m in methods])

        def fin(res, head=bytes(head), lane_cands=lane_cands):
            streams = []
            for cands in lane_cands:
                best = None
                for c in cands:
                    s = _finish(c, res)
                    if s is None:
                        return None
                    if best is None or len(s) < len(best):
                        best = s
                streams.append(best)
            out = bytearray(head)
            for s in streams:
                varint.put_uint(out, len(s))
            for s in streams:
                out += s
            return bytes(out)

        return ("fin", fin)

    if order & rans4x16.X_CAT:
        out = bytearray([rans4x16.X_CAT])
        varint.put_uint(out, in_size)
        return ("done", bytes(out) + data.tobytes())

    from ..ops import pack as packmod
    from ..ops import rle as rlemod

    do_pack = order & rans4x16.X_PACK
    do_rle = order & rans4x16.X_RLE
    no_size = order & rans4x16.X_NOSZ

    head = bytearray()
    head.append(order & 0xFF)
    if not no_size:
        varint.put_uint(head, in_size)
    order &= 0xF

    if do_pack and in_size:
        packed, pmeta, _nsym = packmod.pack(data)
        if len(pmeta) == 1 and pmeta[0] > 16:
            head[0] &= ~rans4x16.X_PACK & 0xFF
        else:
            data = packed
            in_size = len(packed)
            head += pmeta
            varint.put_uint(head, in_size)
    elif do_pack:
        head[0] &= ~rans4x16.X_PACK & 0xFF

    rle_meta_jid = None
    rmeta = rle_len = None
    if do_rle and in_size:
        lits, runs, rle_syms = rlemod.encode(data)
        rmeta = bytes([len(rle_syms) & 0xFF]) + bytes(rle_syms.tolist()) + runs
        rle_len = len(lits)
        if rle_len + len(rmeta) >= 0.99 * in_size:
            head[0] &= ~rans4x16.X_RLE & 0xFF
        else:
            rle_meta_jid = _defer_entropy(
                jobs, np.frombuffer(rmeta, dtype=np.uint8), 0)
            data = lits
            in_size = rle_len
    elif do_rle:
        head[0] &= ~rans4x16.X_RLE & 0xFF

    if order and in_size < 8:
        head[0] &= ~1
        order &= ~1

    # the body is order-1 ONLY for order == 1: low-nibble values 2..15
    # code order-0 (reference rANS_static4x16pr.c:1327)
    jid = _defer_entropy(jobs, data, 1 if order == 1 else 0)

    def fin(res, head=bytes(head), data=data, in_size=in_size,
            jid=jid, rle_meta_jid=rle_meta_jid, rmeta=rmeta,
            rle_len=rle_len, no_size=no_size):
        out = bytearray(head)
        if rle_meta_jid is not None:
            c_rmeta = res.get(rle_meta_jid)
            if c_rmeta is None:
                return None
            if len(c_rmeta) < len(rmeta):
                varint.put_uint(out, len(rmeta) * 2)
                varint.put_uint(out, rle_len)
                varint.put_uint(out, len(c_rmeta))
                out += c_rmeta
            else:
                varint.put_uint(out, len(rmeta) * 2 + 1)
                varint.put_uint(out, rle_len)
                out += rmeta
        body = res.get(jid)
        if body is None:
            return None
        if len(body) >= in_size:
            out[0] = (out[0] & ~3 & 0xFF) | rans4x16.X_CAT | no_size
            body = data.tobytes()
        return bytes(out) + body

    return ("fin", fin)


def _encode_entropy_jobs(jobs: list, engine: str, bodies_fn=None) -> dict:
    """Encode deferred (data, order01) entropy jobs, batching
    same-shape groups through the device engines.  Returns
    {jid: body bytes}."""
    results: dict[int, bytes] = {}
    groups: dict[tuple, list[int]] = defaultdict(list)
    for jid, (data, o) in enumerate(jobs):
        groups[(len(data), o)].append(jid)
    for (n, o), jids in groups.items():
        if (engine != "device" and (len(jids) < DEVICE_MIN_GROUP
                                    or len(jids) * n < DEVICE_MIN_BYTES)) \
                or n < 32:
            for jid in jids:
                d = jobs[jid][0]
                results[jid] = (rans4x16._compress_o1(d) if o
                                else rans4x16._compress_o0(d))
            continue
        batch = np.stack([jobs[j][0] for j in jids])
        bodies = bodies_fn(batch, o) if bodies_fn is not None else None
        if bodies is None:
            bodies = _bodies_o1(batch) if o else _bodies_o0(batch)
        for jid, body in zip(jids, bodies):
            results[jid] = body
    return results


def _compress_blocks_transform(arrs, order: int, engine: str,
                               bodies_fn=None) -> list[bytes]:
    out: list[bytes | None] = [None] * len(arrs)
    jobs: list = []
    fins: list[tuple[int, tuple]] = []
    for i, a in enumerate(arrs):
        try:
            fins.append((i, _peel_encode(a, order, jobs)))
        except ValueError:
            out[i] = rans4x16.compress(a, order)
    res = _encode_entropy_jobs(jobs, engine, bodies_fn) if jobs else {}
    for i, cand in fins:
        s = _finish(cand, res)
        out[i] = s if s is not None else rans4x16.compress(arrs[i], order)
    return out  # type: ignore[return-value]


def _frame(order_byte: int, n: int, body: bytes, data: np.ndarray) -> bytes:
    """Wrapper framing incl. the CAT fallback (compressed >= input)."""
    head = bytearray([order_byte])
    varint.put_uint(head, n)
    if len(body) >= n:
        head[0] = (head[0] & ~3 & 0xFF) | rans4x16.X_CAT
        return bytes(head) + data.tobytes()
    return bytes(head) + body


# Minimum group size for the on-device table builders: below this the
# per-dispatch latency outweighs the host C builder's per-block cost.
TABLES_DEVICE_MIN = 512


def _bodies_o0_devtables(batch: np.ndarray) -> list[bytes] | None:
    """Order-0 entropy bodies with on-device table construction
    (ops/tables_v2.py); None -> caller uses the host-table path."""
    from ..ops import rans_v2, tables_v2
    B, N = batch.shape
    r = tables_v2.build_o0_device(batch)
    if r is None:
        return None
    alpha_d, packed_d, asz, fhdr, A = r
    hdrs = native.serialize_o0_batch(fhdr)
    if hdrs is None:
        return None
    states, words, counts = rans_v2.enc_o0_batch(batch, alpha_d, packed_d)
    return [hdrs[b] + states[b].astype("<u4").tobytes() +
            words[b, :counts[b]].astype("<u2").tobytes()
            for b in range(B)]


def _bodies_o1_devtables(batch: np.ndarray) -> list[bytes] | None:
    """Order-1 entropy bodies with on-device table construction.

    The encode scan runs with a per-block traced shift (mixed 10/12-bit
    batches need no host grouping) and is dispatched BEFORE the host
    pulls the header frequencies and serialises them, so the device
    encodes while the host works.  Blocks flagged by the builder
    (shift-heuristic decision flips) rebuild on the host so streams
    stay byte-exact."""
    import jax.numpy as jnp
    from ..ops import rans_v2, tables_v2
    B, N = batch.shape
    jb = jnp.asarray(batch)
    r = tables_v2.build_o1_device_async(jb)
    if r is None:
        return None
    alpha_d, packed_d, fhdr_d, meta_d, H_d, A = r
    # async dispatch: the scan depends only on device arrays
    states, words, counts, ovf = rans_v2.enc_scan_pb(
        jb, alpha_d, packed_d, meta_d[:, 1], 1)
    # host work overlaps the running scan
    meta = np.asarray(meta_d)
    fhdr = np.asarray(fhdr_d)
    alpha_h = np.asarray(alpha_d)
    asz, shift = meta[:, 0], meta[:, 1]
    flag = tables_v2.resolve_band_flags(meta, H_d)
    hdrs = native.serialize_o1_dense_batch(alpha_h, asz, fhdr, shift)
    if hdrs is None:
        return None
    if bool(np.asarray(ovf)):
        for cap in (rans_v2.SEG_CAP2, rans_v2.SEG):
            states, words, counts, ovf = rans_v2.enc_scan_pb(
                jb, alpha_d, packed_d, meta_d[:, 1], 1, seg_cap=cap)
            if not bool(np.asarray(ovf)):
                break
    states = np.asarray(states)
    counts = np.asarray(counts)
    words = rans_v2.words_to_host(words, counts)
    out: list[bytes | None] = [None] * B
    for b in range(B):
        if flag[b]:
            out[b] = rans4x16._compress_o1(batch[b])
        else:
            out[b] = hdrs[b] + states[b].astype("<u4").tobytes() + \
                words[b, :counts[b]].astype("<u2").tobytes()
    return out  # type: ignore[return-value]


def _bodies_o0(batch: np.ndarray) -> list[bytes]:
    """Entropy bodies (freq header + payload, no wrapper framing) for
    a batch of equal-length blocks, order 0."""
    from ..ops import rans_v2
    B, N = batch.shape
    if not native.available():
        return [rans4x16._compress_o0(batch[b]) for b in range(B)]
    if B >= TABLES_DEVICE_MIN and N >= 32:
        res = _bodies_o0_devtables(batch)
        if res is not None:
            return res
    res = _pmap(native.build_tables_o0, list(batch))
    if any(r is None for r in res):
        return [rans4x16._compress_o0(batch[b]) for b in range(B)]
    hdrs = [r[0] for r in res]
    starts = np.stack([r[1] for r in res])
    freqs = np.stack([r[2] for r in res])
    dense = rans_v2.densify_group_o0(freqs, starts)
    if dense is None:
        # wide alphabet: native scalar coder beats the v1 gather path
        return _pmap(rans4x16._compress_o0, list(batch))
    alpha, packed, _ = dense
    states, words, counts = rans_v2.enc_o0_batch(batch, alpha, packed)
    return [hdrs[b] + states[b].astype("<u4").tobytes() +
            words[b, :counts[b]].astype("<u2").tobytes()
            for b in range(B)]


def _bodies_o1(batch: np.ndarray) -> list[bytes]:
    from ..ops import rans_v2
    B, N = batch.shape
    if N < 8 or not native.available():
        return [rans4x16._compress_o1(batch[b]) for b in range(B)]
    if B >= TABLES_DEVICE_MIN and N >= 32:
        res = _bodies_o1_devtables(batch)
        if res is not None:
            return res
    res = _pmap(native.build_tables_o1_dense, list(batch))
    if any(r is None for r in res):
        # wide alphabet (A > 96) somewhere: such data is rare (random
        # literals usually CAT out); thread the native host coder
        return _pmap(rans4x16._compress_o1, list(batch))
    hdrs = [r[0] for r in res]
    shifts = np.array([r[3] for r in res], np.int32)
    out = [None] * B
    for shift in np.unique(shifts):
        sel = np.flatnonzero(shifts == shift)
        sub = batch[sel]
        alpha, packed, _ = rans_v2.densify_builds(
            (res[b][1], res[b][2]) for b in sel)
        states, words, counts = rans_v2.enc_o1_batch(
            sub, alpha, packed, int(shift))
        for k, b in enumerate(sel):
            out[b] = hdrs[b] + states[k].astype("<u4").tobytes() + \
                words[k, :counts[k]].astype("<u2").tobytes()
    return out  # type: ignore[return-value]


def _compress_batch_o0(batch: np.ndarray) -> list[bytes]:
    B, N = batch.shape
    return [_frame(0, N, body, batch[b])
            for b, body in enumerate(_bodies_o0(batch))]


def _compress_batch_o1(batch: np.ndarray) -> list[bytes]:
    B, N = batch.shape
    return [_frame(1, N, body, batch[b])
            for b, body in enumerate(_bodies_o1(batch))]


def r4x8_compress_blocks(blocks, order: int, engine: str = "auto",
                         enc_fn=None) -> list[bytes]:
    """Compress a sequence of blocks with the rANS 4x8 codec (CRAM
    3.0), batching the payload scans onto the device.

    enc_fn: optional payload-scan engine ``(batch (B,N) u8, alpha,
    packed, order01) -> (states, bytes, counts) | None`` — the
    sharded layer (parallel.distributed.sharded_enc8_fn) injects a
    shard_map over the device mesh here; None falls back to the
    single-device engines."""
    from . import rans4x8
    from ..ops import rans_v2, rans8_v2
    arrs = [_as_u8(b) for b in blocks]
    out: list[bytes | None] = [None] * len(arrs)
    groups: dict[int, list[int]] = defaultdict(list)
    for i, a in enumerate(arrs):
        if order in (0, 1) and engine != "host" and len(a) >= 8:
            groups[len(a)].append(i)
        else:
            out[i] = rans4x8.compress(a, order)
    for n, idxs in groups.items():
        if engine != "device" and (len(idxs) < DEVICE_MIN_GROUP
                                   or len(idxs) * n < DEVICE_MIN_BYTES):
            for i in idxs:
                out[i] = rans4x8.compress(arrs[i], order)
            continue
        batch = np.stack([arrs[i] for i in idxs])
        if native.available():
            res = _pmap(lambda b: native.r8_build_tables_dense(b, order),
                        list(batch))
        else:
            res = [None]
        if any(r is None for r in res):
            for i in idxs:
                out[i] = rans4x8.compress(arrs[i], order)
            continue
        if order == 1:
            dense = rans_v2.densify_builds((r[1], r[2]) for r in res)
        else:
            # order-0 dense rows pad like densify_builds' O1 rows
            A = rans_v2._round_a(max(len(r[1]) for r in res))
            alpha = np.zeros((len(res), A), np.uint8)
            packed = np.zeros((len(res), A), np.int32)
            for k, r in enumerate(res):
                al, pk = r[1], r[2]
                alpha[k, :len(al)] = al
                alpha[k, len(al):] = al[-1] if len(al) else 0
                packed[k, :len(pk)] = pk
            dense = (alpha, packed, A)
        if dense is None:
            for i in idxs:
                out[i] = rans4x8.compress(arrs[i], order)
            continue
        alpha, packed, _ = dense
        res8 = enc_fn(batch, alpha, packed, order) \
            if enc_fn is not None else None
        if res8 is None:
            enc = (rans8_v2.enc_o1_batch if order
                   else rans8_v2.enc_o0_batch)
            res8 = enc(batch, alpha, packed)
        states, wbytes, counts = res8
        for k, i in enumerate(idxs):
            tab = res[k][0]
            payload = states[k].astype("<u4").tobytes() + \
                wbytes[k, :counts[k]].astype(np.uint8).tobytes()
            comp_sz = len(tab) + len(payload)
            head = bytearray([order])
            head += comp_sz.to_bytes(4, "little")
            head += n.to_bytes(4, "little")
            out[i] = bytes(head) + tab + payload
    return out  # type: ignore[return-value]


def r4x8_uncompress_blocks(streams, engine: str = "auto",
                           dec_fn=None) -> list[bytes]:
    """Decompress a sequence of rANS 4x8 streams, batching payload
    scans onto the device.

    dec_fn: optional decode-group engine ``(order01, osz, states,
    stream (B,W) u8, alpha, packed) -> (B, osz) u8 | None`` — the
    sharded layer (parallel.distributed.sharded_dec8_fn) injects a
    shard_map here."""
    from . import rans4x8
    from ..ops import rans_v2, rans8_v2
    streams = [bytes(s) for s in streams]
    out: list[bytes | None] = [None] * len(streams)
    groups: dict[tuple, list] = defaultdict(list)
    for i, s in enumerate(streams):
        if len(s) < 9 or s[0] not in (0, 1) or engine == "host":
            out[i] = rans4x8.uncompress(s)
            continue
        osz = int.from_bytes(s[5:9], "little")
        groups[(s[0], osz)].append((i, s))
    for (order, osz), items in groups.items():
        if (engine != "device" and (len(items) < DEVICE_MIN_GROUP
                                    or len(items) * osz < DEVICE_MIN_BYTES)) \
                or osz < 4:
            for i, s in items:
                out[i] = rans4x8.uncompress(s)
            continue
        parsed = []
        ok = True
        for i, s in items:
            r = (rans4x8.parse_tables_o1(s) if order
                 else rans4x8.parse_tables_o0(s))
            if r is None:
                ok = False
                break
            parsed.append(r)
        dense = None
        if ok:
            if order == 1:
                dense = rans_v2.densify_builds(
                    (r[2], r[3]) for r in parsed)
            else:
                dense = rans_v2.densify_group_o0(
                    np.stack([r[4] for r in parsed]),
                    np.stack([r[5] for r in parsed]))
        if dense is None:
            for i, s in items:
                out[i] = rans4x8.uncompress(s)
            continue
        alpha, packed, _ = dense
        B = len(items)
        W = max(len(s) - r[0] - 16 for (_i, s), r in zip(items, parsed))
        states = np.zeros((B, 4), np.uint32)
        stream = np.zeros((B, max(W, 1)), np.uint8)
        bad = False
        for k, ((_i, s), r) in enumerate(zip(items, parsed)):
            pos = r[0]
            states[k] = np.frombuffer(s[pos:pos + 16], "<u4")
            if (states[k] < rans8_v2.RANS8_L).any():
                bad = True
                break
            body = np.frombuffer(s[pos + 16:], np.uint8)
            stream[k, :len(body)] = body
        if bad:
            for i, s in items:
                out[i] = rans4x8.uncompress(s)
            continue
        res = dec_fn(order, osz, states, stream, alpha, packed) \
            if dec_fn is not None else None
        if res is None:
            dec = (rans8_v2.dec_o1_batch if order
                   else rans8_v2.dec_o0_batch)
            res = dec(states, stream, osz, alpha, packed)
        for k, (i, _s) in enumerate(items):
            out[i] = res[k].tobytes()
    return out  # type: ignore[return-value]


def arith_compress_blocks(blocks, order: int, engine: str = "auto") -> list[bytes]:
    """Compress a sequence of blocks with the adaptive arith codec.

    engine: "auto" (native host kernels on a thread pool — the
    adaptive coder is byte-serial), "device" (batched XLA scan engines
    of ops/arith_jax.py, bitstream-exact), or "host".
    """
    from . import arith as arithmod
    arrs = [_as_u8(b) for b in blocks]
    if engine != "device":
        return [arithmod.compress(a, order) for a in arrs]

    from ..ops import arith_jax
    out: list[bytes | None] = [None] * len(arrs)
    plain = order in (0, 1)
    groups: dict[int, list[int]] = defaultdict(list)
    for i, a in enumerate(arrs):
        if plain and len(a) >= 8:
            groups[len(a)].append(i)
        else:
            out[i] = arithmod.compress(a, order)
    for n, idxs in groups.items():
        batch = np.stack([arrs[i] for i in idxs])
        ms = batch.max(axis=1).astype(np.int32) + 1
        lens = np.full(len(idxs), n, np.int32)
        res = arith_jax.enc_batch(batch, lens, ms, order)
        if res is None:
            for i in idxs:
                out[i] = arithmod.compress(arrs[i], order)
            continue
        for k, i in enumerate(idxs):
            head = bytearray([order])
            varint.put_uint(head, n)
            body = bytes([int(ms[k]) & 0xFF]) + res[k]
            if len(body) >= n:
                out[i] = arithmod.compress(arrs[i], order)  # CAT fallback
            else:
                out[i] = bytes(head) + body
    return out  # type: ignore[return-value]


def arith_uncompress_blocks(streams, out_sizes=None,
                            engine: str = "auto") -> list[bytes]:
    """Decompress a sequence of arith streams (device-batched when
    engine="device" and the streams are plain order 0/1)."""
    from . import arith as arithmod
    streams = [bytes(s) for s in streams]
    if engine != "device":
        return [arithmod.uncompress(
            s, out_sizes[i] if out_sizes is not None else None)
            for i, s in enumerate(streams)]

    from ..ops import arith_jax
    out: list[bytes | None] = [None] * len(streams)
    groups: dict[tuple, list] = defaultdict(list)
    for i, s in enumerate(streams):
        if not s:
            raise ValueError("corrupt arith stream")
        flags = s[0]
        if (flags & ~1) != 0 or len(s) < 3:
            out[i] = arithmod.uncompress(
                s, out_sizes[i] if out_sizes is not None else None)
            continue
        osz, pos = varint.get_uint(s, 1, len(s))
        groups[(flags & 1, osz)].append((i, s, pos))
    for (order, osz), items in groups.items():
        payloads = [s[pos + 1:] for _, s, pos in items]
        ms = [s[pos] for _, s, pos in items]
        dec = arith_jax.dec_batch(payloads, [osz] * len(items), ms, order)
        if dec is None:
            for i, s, _ in items:
                out[i] = arithmod.uncompress(s)
            continue
        for k, (i, _s, _p) in enumerate(items):
            out[i] = dec[k][:osz].tobytes()
    return out  # type: ignore[return-value]


def _peel_wrapper(s: bytes, out_size):
    """Parse a non-STRIPE rans4x16 wrapper down to its entropy payload.

    Mirrors rans4x16._uncompress_into (reference
    rANS_static4x16pr.c:1435-1584) but DEFERS the entropy decode so
    payloads from many blocks batch together.  Returns
    (kind, ...) where kind is:
      "cat":     (data np.uint8,)                 — finished output
      "entropy": (order, body bytes, tmp1_size, post)  — post(tmp1)->np
    or None for anything this path cannot handle (caller falls back).
    """
    from ..ops import pack as packmod
    from ..ops import rle as rlemod
    end = len(s)
    if end == 0:
        return None
    order = s[0]
    if order & rans4x16.X_STRIPE:
        return None
    pos = 1
    do_pack = order & rans4x16.X_PACK
    do_rle = order & rans4x16.X_RLE
    do_cat = order & rans4x16.X_CAT
    no_size = order & rans4x16.X_NOSZ
    order &= 1
    try:
        if not no_size:
            osz, pos = varint.get_uint(s, pos, end)
        else:
            if out_size is None:
                return None
            osz = out_size
        if out_size is not None and osz > out_size:
            return None
        tmp1_size = osz

        pmap = None
        vpb = 0
        if do_pack:
            pmap, vpb, pos = packmod.unpack_meta(s, pos, end)
            if pmap is None:
                return None
            psz, pos = varint.get_uint(s, pos, end)
            if psz > tmp1_size:
                return None
            tmp1_size = psz

        rle_meta = None
        if do_rle:
            u_meta_size, pos = varint.get_uint(s, pos, end)
            rle_len, pos = varint.get_uint(s, pos, end)
            if rle_len > tmp1_size:
                return None
            if u_meta_size & 1:
                u_meta = min(u_meta_size // 2, end - pos)
                rle_meta = bytes(s[pos:pos + u_meta])
                c_meta_size = u_meta
            else:
                c_meta_size, pos2 = varint.get_uint(s, pos, end)
                u_meta_size //= 2
                blob = rans4x16._uncompress_o0(
                    memoryview(s), pos2, end, u_meta_size)
                if blob is None:
                    return None
                rle_meta = blob.tobytes()
                pos = pos2
            if c_meta_size + pos > end:
                return None
            pos += c_meta_size
            tmp1_size = rle_len
    except Exception:
        return None

    def post(tmp1: np.ndarray):
        tmp2 = tmp1
        if do_rle:
            if rle_meta is None or len(rle_meta) == 0:
                return None
            nsyms = rle_meta[0] if rle_meta[0] else 256
            if len(rle_meta) < 1 + nsyms:
                return None
            tmp2 = rlemod.decode(
                tmp1, rle_meta[1 + nsyms:],
                np.frombuffer(rle_meta[1:1 + nsyms], dtype=np.uint8), osz)
            if tmp2 is None:
                return None
        if do_pack:
            unpacked = len(tmp2) if vpb == 1 else osz
            return packmod.unpack(tmp2, unpacked, vpb, pmap)
        return tmp2

    if end - pos == 0:
        r = post(np.zeros(0, np.uint8))
        return None if r is None else ("cat", r)
    if do_cat:
        if tmp1_size > end - pos or (out_size is not None
                                     and tmp1_size > out_size):
            return None
        r = post(np.frombuffer(s[pos:pos + tmp1_size], np.uint8))
        return None if r is None else ("cat", r)
    return ("entropy", order, s[pos:], tmp1_size, post)


def _peel_stripe(s: bytes, out_size):
    """Parse a STRIPE container into lane sub-streams.  Returns
    (ulen, N, [(sub_buf, lane_len), ...]) or None.  Lane i decodes
    against the rest of the container (rANS_static4x16pr.c:1412-1426).
    """
    end = len(s)
    try:
        ulen, pos = varint.get_uint(s, 1, end)
        if pos >= end:
            return None
        N = s[pos]
        pos += 1
        if N == 0:
            return None
        if out_size is not None and ulen != out_size:
            return None
        clens = []
        tot = 0
        for _ in range(N):
            c, pos = varint.get_uint(s, pos, end)
            if pos > end or c > end or c < 1:
                return None
            clens.append(c)
            tot += c
        if pos + tot > end:
            return None
    except Exception:
        return None
    stripe_end = pos + tot
    lanes = []
    for i in range(N):
        lane_len = ulen // N + (1 if (ulen % N) > i else 0)
        lanes.append((s[pos:stripe_end], lane_len))
        pos += clens[i]
    return ulen, N, lanes


def uncompress_blocks(streams, out_sizes=None, engine: str = "auto",
                      dec_fn=None) -> list[bytes]:
    """Decompress a sequence of rANS 4x16 streams.

    Transform-flagged streams (PACK/RLE/CAT/NOSZ and STRIPE
    containers) are peeled host-side and their entropy payloads —
    including every stripe lane — join the same batched device decode
    as the plain streams.

    dec_fn: optional decode-group engine ``(order01, osz, states,
    words, alpha, packed, shift) -> (B, osz) u8 | None`` injected by
    the sharded layer (parallel/distributed.py)."""
    streams = [bytes(s) for s in streams]
    out: list[bytes | None] = [None] * len(streams)
    if any(not s for s in streams):
        raise ValueError("corrupt rans4x16 stream")

    use_batch = engine != "host" and native.available()

    # ---- peel wrappers into deferred entropy jobs --------------------
    # job: (jid, order, body, tmp1_size); finishers run after decode
    jobs: list[tuple] = []
    finishers: list[tuple] = []       # (i, kind, state)
    for i, s in enumerate(streams):
        osize = out_sizes[i] if out_sizes is not None else None
        if not use_batch:
            out[i] = rans4x16.uncompress(s, osize)
            continue
        if s[0] & rans4x16.X_STRIPE:
            st = _peel_stripe(s, osize)
            if st is None:
                out[i] = rans4x16.uncompress(s, osize)
                continue
            ulen, N, lanes = st
            lane_ids = []
            bad = False
            for sub, lane_len in lanes:
                p = _peel_wrapper(sub, lane_len)
                if p is None:
                    bad = True
                    break
                if p[0] == "cat":
                    if len(p[1]) != lane_len:
                        bad = True
                        break
                    lane_ids.append(("done", p[1]))
                else:
                    _k, order, body, t1, post = p
                    jid = len(jobs)
                    jobs.append((jid, order, body, t1))
                    lane_ids.append(("job", jid, post, lane_len))
            if bad:
                out[i] = rans4x16.uncompress(s, osize)
                continue
            finishers.append((i, "stripe", (ulen, N, lane_ids)))
        else:
            p = _peel_wrapper(s, osize)
            if p is None:
                out[i] = rans4x16.uncompress(s, osize)
            elif p[0] == "cat":
                out[i] = p[1].tobytes()
            else:
                _k, order, body, t1, post = p
                jid = len(jobs)
                jobs.append((jid, order, body, t1))
                finishers.append((i, "plain", (jid, post)))

    results = _decode_entropy_jobs(jobs, engine, dec_fn) if jobs else {}

    # ---- assemble ----------------------------------------------------
    for i, kind, state in finishers:
        if kind == "plain":
            jid, post = state
            tmp1 = results.get(jid)
            r = post(tmp1) if tmp1 is not None else None
            if r is None:
                out[i] = rans4x16.uncompress(
                    streams[i],
                    out_sizes[i] if out_sizes is not None else None)
            else:
                out[i] = r.tobytes()
        else:
            ulen, N, lane_ids = state
            buf = np.zeros(ulen, np.uint8)
            ok = True
            for li, entry in enumerate(lane_ids):
                if entry[0] == "done":
                    lane = entry[1]
                else:
                    _t, jid, post, lane_len = entry
                    tmp1 = results.get(jid)
                    lane = post(tmp1) if tmp1 is not None else None
                    if lane is None or len(lane) != lane_len:
                        ok = False
                        break
                buf[li::N] = lane
            if ok:
                out[i] = buf.tobytes()
            else:
                out[i] = rans4x16.uncompress(
                    streams[i],
                    out_sizes[i] if out_sizes is not None else None)
    return out  # type: ignore[return-value]


def _decode_entropy_jobs(jobs, engine: str, dec_fn=None) -> dict:
    """Decode a list of (jid, order, body, out_sz) rans4x16 entropy
    payloads, batching same-shape groups onto the device.  Returns
    {jid: np.uint8 array} (missing jid = parse failure)."""
    results: dict[int, np.ndarray] = {}
    groups: dict[tuple, list] = defaultdict(list)
    for jid, order, s, osz in jobs:
        if osz == 0:
            results[jid] = np.zeros(0, np.uint8)
            continue
        if order == 1:
            r = native.parse_tables_o1_dense(s)
            if r is not None:
                off, alpha, packed, shift = r
                groups[(1, osz, shift)].append((jid, s, off, alpha, packed))
            else:
                # wide alphabet (A > 96): the native scalar decoder;
                # rare in practice (wide random data CATs out)
                rr = rans4x16._uncompress_o1(memoryview(s), 0, len(s), osz)
                if rr is not None:
                    results[jid] = rr
        else:
            r = native.parse_tables_o0(s)
            if r is None:
                continue
            off, ssym, sfreq, sbase = r
            groups[(0, osz)].append((jid, s, off, ssym, sfreq, sbase))

    from ..ops import rans_v2
    for key, items in groups.items():
        order, osz = key[0], key[1]
        if engine != "device" and (len(items) < DEVICE_MIN_GROUP
                                   or len(items) * osz < DEVICE_MIN_BYTES):
            for it in items:
                jid, s = it[0], it[1]
                r = (rans4x16._uncompress_o1(memoryview(s), 0, len(s), osz)
                     if order else
                     rans4x16._uncompress_o0(memoryview(s), 0, len(s), osz))
                if r is not None:
                    results[jid] = r
            continue
        B = len(items)
        W = max((len(s) - off - 16) // 2 for _, s, off, *_ in items)
        states = np.zeros((B, 4), np.uint32)
        words = np.zeros((B, max(W, 1)), "<u2")
        for k, (_, s, off, *_t) in enumerate(items):
            states[k] = np.frombuffer(s[off:off + 16], "<u4")
            w = np.frombuffer(s[off + 16: off + 16 + 2 * ((len(s) - off - 16) // 2)], "<u2")
            words[k, :len(w)] = w
        if order == 1:
            shift = key[2]
            alpha, packed, _ = rans_v2.densify_builds(
                (t[3], t[4]) for t in items)
            dec = dec_fn(1, osz, states, words, alpha, packed,
                         shift) if dec_fn is not None else None
            if dec is None:
                dec = rans_v2.dec_o1_batch(states, words, osz, alpha,
                                           packed, shift)
        else:
            # per-slot LUTs -> per-symbol tables: sbase[m] = m - start
            frs = np.zeros((B, 256), np.uint32)
            sts = np.zeros((B, 256), np.uint32)
            tot = items[0][4].shape[0]
            slot = np.arange(tot, dtype=np.uint32)
            for k, t in enumerate(items):
                sym = t[3].astype(np.int64)
                frs[k, sym] = t[4]
                sts[k, sym] = slot - t[5]
            dense = rans_v2.densify_group_o0(frs, sts)
            if dense is None:
                for it in items:
                    rr = rans4x16._uncompress_o0(
                        memoryview(it[1]), 0, len(it[1]), osz)
                    if rr is not None:
                        results[it[0]] = rr
                continue
            alpha, packed, _ = dense
            dec = dec_fn(0, osz, states, words, alpha, packed,
                         12) if dec_fn is not None else None
            if dec is None:
                dec = rans_v2.dec_o0_batch(states, words, osz, alpha,
                                           packed)
        for k, it in enumerate(items):
            results[it[0]] = dec[k]

    return results


def fqz_compress_blocks(jobs) -> list[bytes]:
    """Compress many fqzcomp_qual slices concurrently.

    jobs: sequence of (data, lens[, flags[, strat]]) tuples as accepted
    by models.fqz.compress.  The fqz model scan is native C (GIL
    released), so slices parallelise across host cores; the adaptive
    65536-context model is far too large for useful on-chip batching
    (SURVEY.md section 5, long-context note), so blocks-across-cores
    IS the fqz scaling axis.
    """
    from . import fqz as fqzmod

    def one(job):
        data, lens, *rest = job
        flags = rest[0] if len(rest) > 0 else None
        strat = rest[1] if len(rest) > 1 else 0
        return fqzmod.compress(data, lens, flags, strat=strat)

    return _pmap(one, list(jobs))


def fqz_decompress_blocks(streams) -> list[bytes]:
    """Decompress many fqzcomp_qual streams concurrently."""
    from . import fqz as fqzmod
    return _pmap(fqzmod.decompress, [bytes(s) for s in streams])
