"""Pipelined small-batch rANS 4x16 encode.

Why: real CRAM writers hand the codec a stream of small slices (a few
hundred 64 KiB blocks at a time — cf. the reference test tools' block
loop, tests/rANS_static4x16pr_test.c:190-207).  A one-shot small batch
is bound by per-pass fixed costs, not compute: device->host transfer
latencies and executable dispatch.  Those costs pipeline across
consecutive batches: batch k's host work (meta/frequency transfer,
header serialization, stream assembly) runs while batch k+1's device
work (table build + encode) is in flight.

``StreamEncoder`` keeps up to ``depth`` batches in flight.  Streams
are byte-identical to ``rans4x16.compress(block, order)`` for plain
order 0/1 (asserted in tests/test_streaming.py); transform-flagged
orders belong to models.batch.

Reference: rANS_static4x16pr.c:378-494 (O0), :694-846 (O1); framing
:1231-1240 with the CAT expansion fallback :1332-1337.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from .. import native
from ..models import rans4x16
from ..utils import varint


class _Pending:
    __slots__ = ("blocks", "jb", "tables", "scan", "order", "assemble")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class StreamEncoder:
    """Pipelined encoder for a stream of equal-shape (B, N) batches.

    Usage::

        enc = StreamEncoder(order=1, depth=2)
        for batch in batches:          # (B, N) u8 arrays
            enc.submit(batch)
            for streams in enc.drain_ready():
                ...                    # list[bytes], one per block
        for streams in enc.finish():
            ...

    ``depth`` bounds device memory: at most ``depth`` batches of
    device arrays are live.  ``assemble=False`` skips the payload
    device->host pull and returns (hdrs, states_dev, words_dev,
    counts, flags, shifts) tuples instead of assembled byte streams —
    the form bench.py's device-side verifier consumes.
    """

    def __init__(self, order: int = 1, depth: int = 2,
                 assemble: bool = True, seg_cap: int | None = None,
                 hdr: str = "auto"):
        if order not in (0, 1):
            raise ValueError("StreamEncoder handles plain order 0/1")
        if hdr not in ("auto", "u16", "s12"):
            raise ValueError("hdr must be auto/u16/s12")
        self.order = order
        self.depth = max(int(depth), 1)
        self.assemble = assemble
        # seg_cap: first compaction tier of the XLA encode scan (the
        # overflow-retry ladder in _collect still guarantees progress;
        # the GPU kernel never overflows)
        self.seg_cap = seg_cap
        # header-frequency transport: 'u16' ships the dense (B, A, A)
        # table; 's12' ships a presence bitmap + row-compacted 12-bit
        # nonzeros (~40% of the dense bytes on real order-1 tables)
        # consumed by the native C serializer.  'auto' picks s12 for
        # wide alphabets.
        self.hdr = hdr
        # s12 prefix width (value pairs) learned from previous
        # batches: homogeneous streams settle after the first batch
        self._nzpairs: int | None = None
        self._q: deque[_Pending] = deque()
        self._ready_buf: list = []

    # -- device side ---------------------------------------------------

    def submit(self, blocks) -> None:
        """Dispatch one batch's device work; never blocks on device
        results (the H2D staging copy is synchronous in jax).

        ``blocks`` may be a numpy array OR an already-staged device
        array (e.g. a slice of a resident corpus): the latter skips
        the H2D copy, but then ``assemble=False`` is required (the
        host-side CAT framing and wide-alphabet fallback need host
        bytes)."""
        import jax
        import jax.numpy as jnp
        from ..ops import rans_v2, tables_v2

        staged = isinstance(blocks, jax.Array)
        if staged and self.assemble:
            raise ValueError("pre-staged submit requires assemble=False")
        if not staged:
            blocks = np.ascontiguousarray(np.asarray(blocks, np.uint8))
        if blocks.ndim != 2:
            raise ValueError("submit expects a (B, N) batch")
        while len(self._q) >= self.depth:
            # bound in-flight device memory; callers normally drain
            self._ready_buf.append(self._collect(self._q.popleft()))
        jb = blocks if staged else jnp.asarray(blocks)
        if staged:
            blocks = None
        if self.order == 1:
            st = tables_v2.build_o1_device_async(jb)
        else:
            st = None
        if st is None and self.order == 1:
            # wide alphabet / tiny blocks: host path at collect time
            if blocks is None:
                blocks = np.asarray(jb)
            self._q.append(_Pending(blocks=blocks, jb=None, tables=None,
                                    scan=None, order=self.order,
                                    assemble=self.assemble))
            return
        if self.order == 0:
            from ..ops import tables_v2 as tv
            if blocks is None:
                blocks = np.asarray(jb)
            r0 = tv.build_o0_device(blocks)
            if r0 is None:
                self._q.append(_Pending(blocks=blocks, jb=None,
                                        tables=None, scan=None,
                                        order=0,
                                        assemble=self.assemble))
                return
            alpha_d, packed_d, asz, fhdr, A = r0
            states, words, counts = rans_v2.enc_o0_batch(
                blocks, alpha_d, packed_d)
            self._q.append(_Pending(
                blocks=blocks, jb=jb, tables=("o0", asz, fhdr),
                scan=(states, words, counts, None),
                order=0, assemble=self.assemble))
            return
        alpha_d, packed_d, fhdr_d, meta_d, H_d, A = st
        s12 = (self.hdr == "s12"
               or (self.hdr == "auto" and A > 8
                   and native.get_lib() is not None))
        if s12:
            # sparse transport: pack BEFORE the scan dispatch so the
            # D2H rides the DMA path under it
            bm_d, v12_d, _cnts, maxnz_d = tables_v2.pack_freqs_sparse12(
                fhdr_d)
            P = v12_d.shape[1] // 3
            tp = P if self._nzpairs is None else min(self._nzpairs, P)
            v_sl = v12_d[:, :3 * tp]
            hdr_src = (bm_d, v_sl, v12_d, maxnz_d, tp)
        else:
            hdr_src = None
        st_d, w_d, n_d, ovf = rans_v2.enc_scan_pb(
            jb, alpha_d, packed_d, meta_d[:, 1], 1,
            seg_cap=self.seg_cap or rans_v2.SEG_CAP)
        # enqueue the transfers NOW: they ride the DMA path under the
        # scan and under the NEXT batch's device work, so collect()
        # pays (at most) one latency instead of three
        pulls = [meta_d, alpha_d, st_d, n_d]
        if s12:
            pulls += [hdr_src[0], hdr_src[1], hdr_src[3]]
        else:
            pulls.append(fhdr_d)
        for arr in pulls:
            try:
                arr.copy_to_host_async()
            except Exception:
                pass
        self._q.append(_Pending(
            blocks=blocks, jb=jb,
            tables=("o1", alpha_d, packed_d, fhdr_d, meta_d, H_d,
                    hdr_src),
            scan=(st_d, w_d, n_d, ovf), order=1,
            assemble=self.assemble))

    # -- host side -------------------------------------------------------

    def _collect(self, p: _Pending):
        from ..ops import rans_v2, tables_v2
        if p.tables is None:                  # host fallback
            return [rans4x16.compress(b, p.order) for b in p.blocks]
        B, N = (p.blocks if p.blocks is not None else p.jb).shape
        if p.order == 0:
            _tag, asz, fhdr = p.tables
            hdrs = native.serialize_o0_batch(fhdr)
            states, words, counts = p.scan[:3]
            if hdrs is None:
                return [rans4x16.compress(b, 0) for b in p.blocks]
            states = np.asarray(states)
            words = np.asarray(words)
            counts = np.asarray(counts)
            out = []
            for b in range(B):
                body = hdrs[b] + states[b].astype("<u4").tobytes() + \
                    words[b, :counts[b]].astype("<u2").tobytes()
                out.append(_frame_plain(0, N, body, p.blocks[b]))
            return out
        _tag, alpha_d, packed_d, fhdr_d, meta_d, H_d, hdr_src = p.tables
        st_d, w_d, n_d, ovf = p.scan
        meta = np.asarray(meta_d)
        alpha_h = np.asarray(alpha_d)
        asz, shift = meta[:, 0], meta[:, 1]
        flag = tables_v2.resolve_band_flags(meta, H_d)
        if hdr_src is not None:
            bm_d, v_sl, v12_d, maxnz_d, tp = hdr_src
            mx = int(np.asarray(maxnz_d))
            need = -(-mx // 2)
            if need > tp:                 # prefix too narrow: re-pull
                v_sl = v12_d[:, :3 * need]
            self._nzpairs = max(self._nzpairs or 0,
                                -(-need * 5 // 4))
            hdrs = native.serialize_o1_sparse12_batch(
                alpha_h, asz, np.asarray(bm_d), np.asarray(v_sl),
                shift)
        else:
            fhdr = np.asarray(fhdr_d)
            hdrs = native.serialize_o1_dense_batch(alpha_h, asz, fhdr,
                                                   shift)
        if hdrs is None:
            return [rans4x16.compress(b, 1) for b in p.blocks]
        if bool(np.asarray(ovf)):
            for cap in (rans_v2.SEG_CAP2, rans_v2.SEG):
                st_d, w_d, n_d, ovf = rans_v2.enc_scan_pb(
                    p.jb, alpha_d, packed_d, meta_d[:, 1], 1, seg_cap=cap)
                if not bool(np.asarray(ovf)):
                    break
        counts = np.asarray(n_d)
        if not p.assemble:
            return (hdrs, st_d, w_d, counts, flag, shift)
        states = np.asarray(st_d)
        words = rans_v2.words_to_host(w_d, counts)
        out = []
        for b in range(B):
            if flag[b]:
                body = rans4x16._compress_o1(p.blocks[b])
            else:
                body = hdrs[b] + states[b].astype("<u4").tobytes() + \
                    words[b, :counts[b]].astype("<u2").tobytes()
            out.append(_frame_plain(1, N, body, p.blocks[b]))
        return out

    def drain_ready(self):
        """Collect every batch whose pipeline slot must free up (plus
        any force-collected during submit); keeps ``depth`` in flight."""
        out = list(getattr(self, "_ready_buf", []))
        self._ready_buf = []
        while len(self._q) > self.depth - 1:
            out.append(self._collect(self._q.popleft()))
        return out

    def finish(self):
        """Collect all remaining in-flight batches."""
        out = list(getattr(self, "_ready_buf", []))
        self._ready_buf = []
        while self._q:
            out.append(self._collect(self._q.popleft()))
        return out


def _frame_plain(order_byte: int, n: int, body: bytes,
                 data: np.ndarray) -> bytes:
    """Plain-order wrapper framing incl. the CAT expansion fallback
    (rANS_static4x16pr.c:1231-1240, :1332-1337)."""
    head = bytearray([order_byte])
    varint.put_uint(head, n)
    if len(body) >= n:
        head[0] = rans4x16.X_CAT
        return bytes(head) + data.tobytes()
    return bytes(head) + body


def encode_batches(batches, order: int = 1, depth: int = 2):
    """Encode an iterable of (B, N) batches, pipelined; yields one
    list[bytes] per batch, in submit order."""
    enc = StreamEncoder(order=order, depth=depth)
    for batch in batches:
        enc.submit(batch)
        for r in enc.drain_ready():
            yield r
    for r in enc.finish():
        yield r
