"""Multi-chip / multi-host scale-out for the rANS 4x16 codec.

The codec has no cross-block dataflow (SURVEY §2): scale-out is
block-level data parallelism over a 1-D device mesh, with only three
kinds of cross-host traffic, all O(scalars) or O(#blocks):

- table-build coordination: the global max alphabet size (one pmax)
  and the compaction-overflow retry verdict (one pmax);
- the ragged container index: per-block compressed lengths allgather
  so every process knows its blocks' global byte offsets;
- nothing else — compressed payloads stay on the host that produced
  them (each process writes its own archive segment).

Entry points:
- ``init_distributed``       jax.distributed bring-up for N>=2 hosts
- ``block_mesh``             1-D mesh over the global devices
- ``compress_blocks``        sharded encode of RAGGED, transform-
                             flagged batches (any order bit-field):
                             models.batch peels transforms and groups
                             by shape; each group runs one shard_map
- ``uncompress_blocks``      sharded decode, same generality
- ``compress_blocks_o1``     sharded order-1 encode (per-block traced
                             shift: mixed 10/12-bit batches run in one
                             shard_map, no host-side grouping)
- ``uncompress_blocks_o1``   sharded decode of equal-size streams
- ``r4x8_compress_blocks`` / ``r4x8_uncompress_blocks``
                             sharded rANS 4x8 (CRAM 3.0): payload
                             scans shard_map over the mesh
- ``arith_*`` / ``fqz_*`` / ``tok3_*``
                             block-DP scale-out for the adaptive
                             codecs (per-process multi-core host
                             engines; blocks ARE their scaling axis)
- ``archive_offsets``        ragged global offsets from local lengths

Single-process multi-device works identically (the dryrun path); with
``jax.distributed`` initialised the same code runs one process per
host with local shards.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import native
from ..models import rans4x16
from ..ops import rans_v2, tables_v2
from ..utils import varint


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kw) -> bool:
    """Bring up jax.distributed for a multi-host run.  No-op (returns
    False) when no arguments are given and JAX coordinator env vars
    are absent; returns True after initialising."""
    import os
    if (coordinator_address is None and num_processes is None
            and "JAX_COORDINATOR_ADDRESS" not in os.environ):
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)
    return True


def block_mesh(axis_name: str = "b", devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def local_mesh(axis_name: str = "b") -> Mesh:
    """Mesh over THIS process's devices only: shard_map over it issues
    no cross-host collectives, so data-dependent group structures
    (ragged/transform batches) cannot desynchronise processes."""
    return Mesh(np.asarray(jax.local_devices()), (axis_name,))


def _mesh_is_local(mesh: Mesh) -> bool:
    pi = jax.process_index()
    return all(d.process_index == pi for d in mesh.devices.flat)


def _allgather_max(x: int) -> int:
    """Global max of a host scalar (identity for single-process)."""
    if jax.process_count() == 1:
        return int(x)
    from jax.experimental import multihost_utils
    vals = multihost_utils.process_allgather(np.asarray([x], np.int64))
    return int(np.max(vals))


def _to_global(local_rows: np.ndarray, mesh: Mesh):
    """Local (per-process) rows -> a global array sharded over the
    mesh's first axis.  Row counts must match the per-process device
    share (callers pad)."""
    spec = P(mesh.axis_names[0], *([None] * (local_rows.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1 or _mesh_is_local(mesh):
        return jax.device_put(local_rows, sharding)
    return jax.make_array_from_process_local_data(sharding, local_rows)


def _local_np(garr) -> np.ndarray:
    """This process's rows of a sharded global array, in row order."""
    shards = sorted(garr.addressable_shards,
                    key=lambda s: (s.index[0].start or 0))
    return np.concatenate([np.asarray(s.data) for s in shards])


# ---------------------------------------------------------------------------
# sharded order-1 encode

def _presence_fn(mesh: Mesh):
    ax = mesh.axis_names[0]

    def local(jb):
        pres, amax = tables_v2._presence_jit(jb)
        return pres, lax.pmax(amax, ax)

    return jax.shard_map(local, mesh=mesh, in_specs=P(ax, None),
                         out_specs=(P(ax, None), P()), check_vma=False)


def _encode_fn(mesh: Mesh, A: int, N: int, seg_cap: int):
    ax = mesh.axis_names[0]

    def local(jb, pres):
        # per-shard body must be a pure device function, so this calls
        # the tile jit directly rather than build_o1_device_async
        alpha, packed, fhdr, meta, H = tables_v2._build_o1_jit(
            jb, pres, A, N)
        states, words, counts, ovf = rans_v2.enc_scan_pb(
            jb, alpha, packed, meta[:, 1], 1, seg_cap=seg_cap)
        return (alpha, fhdr, meta, H, states, words, counts,
                lax.pmax(ovf.astype(jnp.int32), ax))

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(ax, None), P(ax, None)),
        out_specs=(P(ax, None), P(ax, None, None), P(ax, None),
                   P(ax, None, None), P(ax, None), P(ax, None),
                   P(ax), P()),
        check_vma=False)


def _pad_rows(arr: np.ndarray, mult: int):
    B = arr.shape[0]
    pad = (-B) % mult
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[:1], pad, axis=0)])
    return arr, B


def _encode_o0_fn(mesh: Mesh, A: int, N: int, seg_cap: int):
    ax = mesh.axis_names[0]

    def local(jb):
        alpha, packed, fhdr, asz = tables_v2._build_o0_jit(jb, A, N)
        states, words, counts, ovf = rans_v2.enc_scan_pb(
            jb, alpha, packed, jnp.full((jb.shape[0],), 12, jnp.int32), 0,
            seg_cap=seg_cap)
        return (alpha, fhdr, asz, states, words, counts,
                lax.pmax(ovf.astype(jnp.int32), ax))

    return jax.shard_map(
        local, mesh=mesh, in_specs=P(ax, None),
        out_specs=(P(ax, None), P(ax, None), P(ax), P(ax, None),
                   P(ax, None), P(ax), P()),
        check_vma=False)


def _trim_words(words_g, local_counts, mesh: Mesh):
    """words_g without the columns no block's words reach, as
    rans_v2.words_to_host trims single-device arrays.  A global mesh
    slices every process's shards alike, so it takes the max count over
    all processes; a local mesh stays free of cross-host collectives."""
    n = int(np.max(local_counts, initial=0))
    if not _mesh_is_local(mesh):
        n = _allgather_max(n)
    return words_g[:, :rans_v2.used_width(n, words_g.shape[1])]


def _sharded_bodies_o1(batch: np.ndarray, mesh: Mesh) -> list[bytes] | None:
    """Order-1 entropy bodies (freq header + payload, no wrapper
    framing) produced by ONE shard_map over the mesh; None -> caller
    falls back.  Blocks whose 10/12-bit shift-band decision actually
    flips (exact f64 replay) re-encode on the host so streams stay
    byte-exact."""
    B, N = batch.shape
    if N < 32 or N >= (1 << 23) or not native.available():
        return None
    nloc = max(len(mesh.local_devices), 1)
    arr, _ = _pad_rows(np.ascontiguousarray(batch, np.uint8), nloc)
    garr = _to_global(arr, mesh)

    pres, amax_g = _presence_fn(mesh)(garr)
    amax = int(np.asarray(amax_g))
    if not _mesh_is_local(mesh):
        amax = _allgather_max(amax)
    if amax > tables_v2.MAX_DENSE_A:
        return None
    A = rans_v2._round_a(amax)

    res = _encode_fn(mesh, A, N, rans_v2.SEG_CAP)(garr, pres)
    if int(np.asarray(res[7])):      # compaction overflow: exact path
        res = _encode_fn(mesh, A, N, rans_v2.SEG)(garr, pres)
    alpha_g, fhdr_g, meta_g, H_g, states_g, words_g, counts_g, _ = res

    # host-local assembly of this process's rows
    alpha = _local_np(alpha_g)
    fhdr = _local_np(fhdr_g)
    meta = _local_np(meta_g)
    states = _local_np(states_g)
    counts = _local_np(counts_g)
    words = _local_np(_trim_words(words_g, counts, mesh))
    asz, shift, flag = meta[:, 0], meta[:, 1], meta[:, 2].copy()
    if flag.any():
        flat = np.flatnonzero(flag)
        Hsel = np.asarray(H_g[flat]) if jax.process_count() == 1 else \
            _local_np(H_g)[flat]
        for k, b in enumerate(flat):
            if tables_v2._pick_shift_exact(Hsel[k], int(asz[b])) == shift[b]:
                flag[b] = 0
    hdrs = native.serialize_o1_dense_batch(alpha, asz, fhdr, shift)
    if hdrs is None:
        return None

    out: list[bytes] = []
    for b in range(B):
        if flag[b]:
            out.append(rans4x16._compress_o1(batch[b]))
            continue
        out.append(hdrs[b] + states[b].astype("<u4").tobytes() +
                   words[b, :counts[b]].astype("<u2").tobytes())
    return out


def _sharded_bodies_o0(batch: np.ndarray, mesh: Mesh) -> list[bytes] | None:
    """Order-0 entropy bodies via one shard_map; None -> fall back."""
    B, N = batch.shape
    if N < 1 or N >= (1 << 23) or not native.available():
        return None
    nloc = max(len(mesh.local_devices), 1)
    arr, _ = _pad_rows(np.ascontiguousarray(batch, np.uint8), nloc)
    garr = _to_global(arr, mesh)

    _pres, amax_g = _presence_fn(mesh)(garr)
    amax = int(np.asarray(amax_g))
    if not _mesh_is_local(mesh):
        amax = _allgather_max(amax)
    if amax > tables_v2.MAX_DENSE_A:
        return None
    A = rans_v2._round_a(amax)

    res = _encode_o0_fn(mesh, A, N, rans_v2.SEG_CAP)(garr)
    if int(np.asarray(res[6])):
        res = _encode_o0_fn(mesh, A, N, rans_v2.SEG)(garr)
    _alpha_g, fhdr_g, _asz_g, states_g, words_g, counts_g, _ = res

    fhdr = _local_np(fhdr_g)
    states = _local_np(states_g)
    counts = _local_np(counts_g)
    words = _local_np(_trim_words(words_g, counts, mesh))
    hdrs = native.serialize_o0_batch(fhdr)
    if hdrs is None:
        return None
    return [hdrs[b] + states[b].astype("<u4").tobytes() +
            words[b, :counts[b]].astype("<u2").tobytes()
            for b in range(B)]


def sharded_bodies_fn(mesh: Mesh):
    """Entropy-body producer for models.batch.compress_blocks'
    ``bodies_fn`` hook: same-shape job groups run one shard_map each
    instead of the single-device engines."""
    def fn(batch: np.ndarray, order01: int):
        return (_sharded_bodies_o1(batch, mesh) if order01
                else _sharded_bodies_o0(batch, mesh))
    return fn


def compress_blocks(blocks, order: int = 1, mesh: Mesh | None = None,
                    engine: str = "auto") -> list[bytes]:
    """Sharded compression of arbitrary blocks: ragged lengths AND any
    reference order bit-field (STRIPE/PACK/RLE/CAT/NOSZ).

    Reuses models.batch's length grouping and transform peeling; every
    same-shape entropy group — plain blocks and deferred STRIPE-lane /
    PACK/RLE payload candidates alike — runs one shard_map over the
    mesh.  Streams byte-identical to
    ``rans4x16.compress``.

    Multi-process (N>=2 hosts): group structure is data-dependent
    (RLE/PACK decisions change job shapes), so under jax.distributed
    the default mesh is THIS process's local devices — cross-host
    scaling stays pure block data-parallelism with zero coordination,
    which is the codec's scaling model anyway.  Pass a global mesh
    explicitly only if every process guarantees the same
    (length, order) group sequence."""
    if mesh is None:
        mesh = block_mesh() if jax.process_count() == 1 else local_mesh()
    from ..models import batch as batchmod
    return batchmod.compress_blocks(blocks, order, engine=engine,
                                    bodies_fn=sharded_bodies_fn(mesh))


def compress_blocks_o1(blocks: np.ndarray, mesh: Mesh | None = None
                       ) -> list[bytes]:
    """Sharded order-1 compression of this process's equal-length
    blocks (B, N).  Streams are byte-identical to
    ``rans4x16.compress(b, 1)``.  Wide alphabets (A > 96) and the rare
    shift-band decision flips rebuild on the host."""
    if mesh is None:
        mesh = block_mesh()
    B, N = blocks.shape
    bodies = _sharded_bodies_o1(np.asarray(blocks, np.uint8), mesh)
    if bodies is None:
        return [rans4x16.compress(b, 1) for b in blocks]
    from ..models.batch import _frame
    return [_frame(1, N, body, blocks[b])
            for b, body in enumerate(bodies)]


# ---------------------------------------------------------------------------
# sharded decode

def _decode_fn(mesh: Mesh, N: int, order: int = 1):
    ax = mesh.axis_names[0]
    ndim = 3 if order == 1 else 2

    def local(states, words, packed, alpha, shiftv):
        return rans_v2.dec_words_pb(states, words, packed, alpha, shiftv,
                                    N, order)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(ax, None), P(ax, None),
                  P(ax, *([None] * (ndim - 1))),
                  P(ax, None), P(ax)),
        out_specs=P(ax, None), check_vma=False)


def _sharded_dec_group(order: int, osz: int, states, words, alpha,
                       packed, shift: int, mesh: Mesh):
    """Decode one same-shape entropy group via one shard_map.  Inputs
    are the dense per-block arrays models.batch already assembled."""
    B = states.shape[0]
    nloc = max(len(mesh.local_devices), 1)
    statesp, _ = _pad_rows(np.ascontiguousarray(states, np.uint32), nloc)
    wordsp, _ = _pad_rows(np.ascontiguousarray(words), nloc)
    alphap, _ = _pad_rows(np.ascontiguousarray(alpha, np.uint8), nloc)
    packedp, _ = _pad_rows(np.ascontiguousarray(packed, np.int32), nloc)
    shiftp = np.full(statesp.shape[0], shift, np.int32)
    out_g = _decode_fn(mesh, osz, order)(
        _to_global(statesp, mesh), _to_global(wordsp, mesh),
        _to_global(packedp, mesh), _to_global(alphap, mesh),
        _to_global(shiftp, mesh))
    return _local_np(out_g)[:B]


def sharded_dec_fn(mesh: Mesh):
    """Decode-group engine for models.batch.uncompress_blocks'
    ``dec_fn`` hook."""
    def fn(order, osz, states, words, alpha, packed, shift):
        return _sharded_dec_group(order, osz, states, words, alpha,
                                  packed, shift, mesh)
    return fn


def uncompress_blocks(streams, out_sizes=None, mesh: Mesh | None = None,
                      engine: str = "auto") -> list[bytes]:
    """Sharded decompression of arbitrary rANS 4x16 streams: mixed
    sizes, PACK/RLE/CAT/NOSZ wrappers and STRIPE containers.  The
    host-side peel comes from models.batch; every same-shape entropy
    group (incl. every stripe lane) decodes in one shard_map.  Under
    jax.distributed the default mesh is local (see compress_blocks)."""
    if mesh is None:
        mesh = block_mesh() if jax.process_count() == 1 else local_mesh()
    from ..models import batch as batchmod
    return batchmod.uncompress_blocks(streams, out_sizes, engine=engine,
                                      dec_fn=sharded_dec_fn(mesh))


def uncompress_blocks_o1(streams, mesh: Mesh | None = None) -> list[bytes]:
    """Sharded decode of equal-output-size plain order-1 streams
    produced by compress_blocks_o1 (falls back to the host decoder for
    anything else)."""
    if mesh is None:
        mesh = block_mesh()
    streams = [bytes(s) for s in streams]

    def host_all():
        return [rans4x16.uncompress(s) for s in streams]

    parsed = []
    N = None
    for s in streams:
        if len(s) < 2 or s[0] != 1:
            return host_all()
        osz, pos = varint.get_uint(s, 1, len(s))
        if N is None:
            N = osz
        elif osz != N:
            return host_all()
        r = native.parse_tables_o1_dense(s[pos:]) if native.available() \
            else None
        if r is None:
            return host_all()
        off, al, pk, sh = r
        payload = s[pos + off:]
        if len(payload) < 16:
            return host_all()
        parsed.append((al, pk, sh, payload))
    if N is None or N < 4:
        return host_all()

    B = len(parsed)
    amax = _allgather_max(max(len(p[0]) for p in parsed))
    if amax > tables_v2.MAX_DENSE_A:
        return host_all()
    A = rans_v2._round_a(amax)
    W = _allgather_max(max((len(p[3]) - 16) // 2 for p in parsed))
    W = max(W, 1)

    alpha = np.zeros((B, A), np.uint8)
    packed = np.zeros((B, A, A), np.int32)
    states = np.zeros((B, 4), np.uint32)
    words = np.zeros((B, W), "<u2")
    shift = np.zeros(B, np.int32)
    for k, (al, pk, sh, payload) in enumerate(parsed):
        a = len(al)
        alpha[k, :a] = al
        alpha[k, a:] = al[-1] if a else 0
        packed[k, :a, :a] = pk
        shift[k] = sh
        states[k] = np.frombuffer(payload[:16], "<u4")
        w = np.frombuffer(payload[16:16 + 2 * ((len(payload) - 16) // 2)],
                          "<u2")
        words[k, :len(w)] = w

    nloc = max(len(mesh.local_devices), 1)
    statesp, _ = _pad_rows(states, nloc)
    wordsp, _ = _pad_rows(words, nloc)
    alphap, _ = _pad_rows(alpha, nloc)
    packedp, _ = _pad_rows(packed, nloc)
    shiftp, _ = _pad_rows(shift, nloc)

    out_g = _decode_fn(mesh, N)(
        _to_global(statesp, mesh), _to_global(wordsp, mesh),
        _to_global(packedp, mesh), _to_global(alphap, mesh),
        _to_global(shiftp, mesh))
    out = _local_np(out_g)[:B]
    return [out[k].tobytes() for k in range(B)]


# ---------------------------------------------------------------------------
# sharded rANS 4x8 (CRAM 3.0) — same block-DP shard_map pattern as the
# 4x16 layer; injected into models.batch.r4x8_* via the enc_fn/dec_fn
# hooks.  Reference dispatch: rANS_static.c:927-943.

def _enc8_fn(mesh: Mesh, order: int, seg_cap: int):
    ax = mesh.axis_names[0]

    def local(jb, alpha, packed):
        from ..ops import rans8_v2
        rf = rans_v2._ENC_VARIANT["row_fetch"] if order == 1 else "onehot"
        if rf not in ("onehot", "take", "b16"):
            rf = "onehot"
        states, out, n, ovf = rans8_v2._enc_scan8(
            jb, alpha, packed, order, seg_cap=seg_cap, row_fetch=rf)
        return states, out, n, lax.pmax(ovf.astype(jnp.int32), ax)

    nd = 3 if order == 1 else 2
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(ax, None), P(ax, None), P(ax, *([None] * (nd - 1)))),
        out_specs=(P(ax, None), P(ax, None), P(ax), P()),
        check_vma=False)


def _dec8_fn(mesh: Mesh, K: int, q: int, N: int, cap: int, order: int):
    ax = mesh.axis_names[0]
    nd = 3 if order == 1 else 2

    def local(states, stream, packed, alpha):
        from ..ops import rans8_v2
        Bb = states.shape[0]
        padded = jnp.zeros((Bb, cap), jnp.int32)
        padded = padded.at[:, :stream.shape[1]].set(
            stream.astype(jnp.int32))
        chunks = padded.reshape(Bb * (cap // rans_v2.CHUNK),
                                rans_v2.CHUNK)
        return rans8_v2._dec8_to_bytes(
            states, chunks, packed, alpha, K, q, N, order,
            win=rans_v2._DEC_VARIANT["win"])

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(ax, None), P(ax, None),
                  P(ax, *([None] * (nd - 1))), P(ax, None)),
        out_specs=P(ax, None), check_vma=False)


def sharded_enc8_fn(mesh: Mesh):
    """Payload-scan engine for models.batch.r4x8_compress_blocks'
    ``enc_fn`` hook: one shard_map per same-shape group."""
    def fn(batch: np.ndarray, alpha, packed, order01: int):
        B = batch.shape[0]
        nloc = max(len(mesh.local_devices), 1)
        batchp, _ = _pad_rows(np.ascontiguousarray(batch, np.uint8), nloc)
        alphap, _ = _pad_rows(np.ascontiguousarray(alpha), nloc)
        packedp, _ = _pad_rows(np.ascontiguousarray(packed), nloc)
        gb = _to_global(batchp, mesh)
        ga = _to_global(alphap, mesh)
        gp = _to_global(packedp, mesh)
        res = _enc8_fn(mesh, order01, rans_v2.SEG_CAP)(gb, ga, gp)
        if int(np.asarray(res[3])):
            res = _enc8_fn(mesh, order01, rans_v2.SEG)(gb, ga, gp)
        return (_local_np(res[0])[:B], _local_np(res[1])[:B],
                _local_np(res[2])[:B])
    return fn


def sharded_dec8_fn(mesh: Mesh):
    """Decode-group engine for models.batch.r4x8_uncompress_blocks'
    ``dec_fn`` hook."""
    def fn(order01, osz, states, stream, alpha, packed):
        B = states.shape[0]
        nloc = max(len(mesh.local_devices), 1)
        statesp, _ = _pad_rows(np.ascontiguousarray(states, np.uint32), nloc)
        streamp, _ = _pad_rows(np.ascontiguousarray(stream), nloc)
        alphap, _ = _pad_rows(np.ascontiguousarray(alpha), nloc)
        packedp, _ = _pad_rows(np.ascontiguousarray(packed), nloc)
        W = streamp.shape[1]
        cap = max(-(-W // rans_v2.CHUNK), 2) * rans_v2.CHUNK
        q = osz >> 2
        if order01 == 1:
            K = q + (osz - 4 * q)
        else:
            K = q = max(q, 1)
        out_g = _dec8_fn(mesh, K, q, osz, cap, order01)(
            _to_global(statesp, mesh), _to_global(streamp, mesh),
            _to_global(packedp, mesh), _to_global(alphap, mesh))
        return _local_np(out_g)[:B]
    return fn


def r4x8_compress_blocks(blocks, order: int = 1, mesh: Mesh | None = None,
                         engine: str = "auto") -> list[bytes]:
    """Sharded rANS 4x8 compression: models.batch's grouping + host
    table build, payload scans in one shard_map per group.  Streams
    byte-identical to ``rans4x8.compress``."""
    if mesh is None:
        mesh = block_mesh() if jax.process_count() == 1 else local_mesh()
    from ..models import batch as batchmod
    return batchmod.r4x8_compress_blocks(blocks, order, engine=engine,
                                         enc_fn=sharded_enc8_fn(mesh))


def r4x8_uncompress_blocks(streams, mesh: Mesh | None = None,
                           engine: str = "auto") -> list[bytes]:
    """Sharded rANS 4x8 decompression (mirror of r4x8_compress_blocks)."""
    if mesh is None:
        mesh = block_mesh() if jax.process_count() == 1 else local_mesh()
    from ..models import batch as batchmod
    return batchmod.r4x8_uncompress_blocks(streams, engine=engine,
                                           dec_fn=sharded_dec8_fn(mesh))


# ---------------------------------------------------------------------------
# adaptive codecs (arith / fqz / tok3): block data-parallel scale-out.
#
# The adaptive coders are byte-serial per block (SURVEY §2 note on
# c_range_coder.h); their pod-scale axis is the same one the reference
# exposes — independent blocks — so the sharded layer partitions
# BLOCKS over processes (each jax.distributed process compresses its
# local share with the batched multi-core host engines, device groups
# where those win) and shares only the ragged archive index
# (archive_offsets).  Within a process these delegate to models.batch;
# across processes no payload bytes ever move.  Reference entry
# points: arith_dynamic.c:760-862, fqzcomp_qual.c:1492-1502,
# tokenise_name3.c:1334-1538.

def arith_compress_blocks(blocks, order: int = 0,
                          mesh: Mesh | None = None,
                          engine: str = "auto") -> list[bytes]:
    """Block-DP arith compression of THIS process's blocks.  Streams
    byte-identical to ``arith.compress``."""
    from ..models import batch as batchmod
    return batchmod.arith_compress_blocks(blocks, order, engine=engine)


def arith_uncompress_blocks(streams, out_sizes=None,
                            mesh: Mesh | None = None,
                            engine: str = "auto") -> list[bytes]:
    from ..models import batch as batchmod
    return batchmod.arith_uncompress_blocks(streams, out_sizes,
                                            engine=engine)


def fqz_compress_blocks(jobs, mesh: Mesh | None = None) -> list[bytes]:
    """Block-DP fqzcomp_qual compression of THIS process's slices
    (each job = (data, lens[, flags[, strat]])), on host cores."""
    from ..models import batch as batchmod
    return batchmod.fqz_compress_blocks(jobs)


def fqz_decompress_blocks(streams, mesh: Mesh | None = None) -> list[bytes]:
    from ..models import batch as batchmod
    return batchmod.fqz_decompress_blocks(streams)


def tok3_encode_blocks(blocks, level: int = 9, use_arith: bool = False,
                       mesh: Mesh | None = None) -> list[bytes]:
    """Block-DP name-tokeniser compression of THIS process's name
    blocks (each block = newline-terminated names, bytes)."""
    from ..models import tok3 as tok3mod
    from ..models.batch import _pmap
    return _pmap(lambda b: tok3mod.encode_names(b, level, use_arith),
                 list(blocks))


def tok3_decode_blocks(blocks, mesh: Mesh | None = None) -> list[bytes]:
    from ..models import tok3 as tok3mod
    from ..models.batch import _pmap
    return _pmap(lambda s: tok3mod.decode_names(s), list(blocks))


# ---------------------------------------------------------------------------
# ragged container index

def archive_offsets(local_lengths) -> tuple[np.ndarray, int]:
    """Global byte offsets for this process's compressed blocks.

    Every process calls this with its per-block stream lengths (equal
    counts across processes — pad with zero-length entries if needed);
    the lengths allgather (the only payload-related cross-host
    traffic) and each process computes its blocks' offsets in the
    concatenated global archive.  Returns (offsets (L,), total_bytes)."""
    ll = np.asarray(local_lengths, np.int64)
    if jax.process_count() == 1:
        offs = np.cumsum(ll) - ll
        return offs, int(ll.sum())
    from jax.experimental import multihost_utils
    allv = multihost_utils.process_allgather(ll)       # (nproc, L)
    flat = allv.reshape(-1)
    offs_all = (np.cumsum(flat) - flat).reshape(allv.shape)
    return offs_all[jax.process_index()], int(flat.sum())
