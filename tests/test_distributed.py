"""Sharded multi-chip encode/decode (parallel/distributed.py) on the
virtual 8-device CPU mesh: assembled streams must be byte-exact vs the
host encoder, and the ragged container index must linearise correctly.
"""

import numpy as np
import pytest

import jax

from htscodecs_tpu import native
from htscodecs_tpu.models import rans4x16
from htscodecs_tpu.parallel import distributed as dist

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native kernels unavailable")


def _mixed_shift_blocks(B=40, N=4096):
    rng = np.random.default_rng(3)
    syms = np.array([35, 45, 56, 70], np.uint8)
    out = np.empty((B, N), np.uint8)
    for b in range(B):
        vals = rng.choice(4, size=N // 8, p=[.05, .1, .15, .7])
        lens = rng.geometric(0.25, size=N // 8).clip(1, 60)
        seq = np.repeat(vals, lens)[:N]
        if len(seq) < N:
            seq = np.pad(seq, (0, N - len(seq)), constant_values=3)
        out[b] = syms[seq]
    return out


def test_sharded_encode_byte_exact_and_roundtrip():
    assert len(jax.devices()) >= 2, "virtual mesh missing"
    mesh = dist.block_mesh()
    blocks = _mixed_shift_blocks()
    streams = dist.compress_blocks_o1(blocks, mesh)
    nshift = set()
    for b, s in enumerate(streams):
        assert s == rans4x16.compress(blocks[b], 1), b
        nshift.add(s[2] >> 4 if len(s) > 2 else 0)
    back = dist.uncompress_blocks_o1(streams, mesh)
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), b


def test_sharded_encode_uniform_alphabet():
    mesh = dist.block_mesh()
    rng = np.random.default_rng(1)
    blocks = (rng.integers(0, 12, (24, 2048)) + 33).astype(np.uint8)
    streams = dist.compress_blocks_o1(blocks, mesh)
    for b, s in enumerate(streams):
        assert s == rans4x16.compress(blocks[b], 1), b
    back = dist.uncompress_blocks_o1(streams, mesh)
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), b


def test_wide_alphabet_falls_back():
    mesh = dist.block_mesh()
    rng = np.random.default_rng(2)
    blocks = rng.integers(0, 250, (10, 1024)).astype(np.uint8)
    streams = dist.compress_blocks_o1(blocks, mesh)
    for b, s in enumerate(streams):
        assert s == rans4x16.compress(blocks[b], 1), b


def _ragged_blocks():
    """Mixed lengths, CRAM-slice-like: two length groups + strays."""
    rng = np.random.default_rng(9)
    blocks = []
    for n in (2048, 2048, 2048, 1536, 1536, 4096, 777):
        vals = rng.choice(np.array([33, 40, 52, 66], np.uint8),
                          size=n, p=[.5, .3, .15, .05])
        blocks.append(vals)
    return blocks


@pytest.mark.parametrize("order", [0, 1])
def test_sharded_ragged_plain(order):
    """Ragged batches: each length group runs one shard_map; streams
    byte-exact vs the host encoder."""
    mesh = dist.block_mesh()
    blocks = _ragged_blocks()
    streams = dist.compress_blocks(blocks, order, mesh, engine="device")
    for b, s in enumerate(streams):
        assert s == rans4x16.compress(blocks[b], order), (order, b)
    back = dist.uncompress_blocks(streams, mesh=mesh, engine="device")
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), (order, b)


@pytest.mark.parametrize("order", [193, 65, 129, 0x08 | (4 << 8)])
def test_sharded_transform_flagged(order):
    """STRIPE/PACK/RLE orders: transform peel host-side, every
    deferred entropy candidate (incl. stripe lanes) shard_mapped."""
    mesh = dist.block_mesh()
    rng = np.random.default_rng(11)
    blocks = []
    for n in (4096, 4096, 4096, 2048):
        vals = rng.choice(np.array([2, 3, 5, 9], np.uint8),
                          size=n, p=[.6, .25, .1, .05])
        blocks.append(np.repeat(vals, 2)[:n])
    streams = dist.compress_blocks(blocks, order, mesh, engine="device")
    for b, s in enumerate(streams):
        assert s == rans4x16.compress(blocks[b], order), (order, b)
    back = dist.uncompress_blocks(streams, mesh=mesh, engine="device")
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), (order, b)


@pytest.mark.parametrize("order", [0, 1, 193])
def test_local_mesh_needs_no_cross_process_collective(order, monkeypatch):
    """Under jax.distributed the default mesh is this process's own
    devices, and group sequences differ between processes: encode and
    decode must then make no cross-process collective."""
    from jax.experimental import multihost_utils

    def no_allgather(*a, **k):
        raise AssertionError("cross-process allgather on a local mesh")

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather", no_allgather)
    blocks = _ragged_blocks()
    streams = dist.compress_blocks(blocks, order, engine="device")
    for b, s in enumerate(streams):
        assert s == rans4x16.compress(blocks[b], order), (order, b)
    back = dist.uncompress_blocks(streams, engine="device")
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), (order, b)


def test_archive_offsets_single_process():
    lens = [5, 0, 17, 3]
    offs, total = dist.archive_offsets(lens)
    assert list(offs) == [0, 5, 5, 22]
    assert total == 25


@pytest.mark.parametrize("order", [0, 1])
def test_sharded_r4x8(order):
    """4x8 (CRAM 3.0) payload scans through the shard_map hooks:
    streams byte-exact vs the host encoder, round-trip exact."""
    from htscodecs_tpu.models import rans4x8
    mesh = dist.block_mesh()
    rng = np.random.default_rng(17)
    blocks = (rng.integers(0, 9, (24, 1500)) ** 2 % 37 + 33).astype(
        np.uint8)
    streams = dist.r4x8_compress_blocks(list(blocks), order, mesh,
                                        engine="device")
    for b, s in enumerate(streams):
        assert s == rans4x8.compress(blocks[b], order), (order, b)
    back = dist.r4x8_uncompress_blocks(streams, mesh, engine="device")
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), (order, b)


def test_blockdp_adaptive_codecs():
    """arith / fqz / tok3 block-DP wrappers: byte-exact vs the
    single-block codecs, plus the archive index."""
    from htscodecs_tpu.models import arith, fqz, tok3
    rng = np.random.default_rng(23)
    blocks = [(rng.integers(0, 6, n) + 40).astype(np.uint8)
              for n in (700, 500, 700)]
    for order in (0, 1, 65):
        st = dist.arith_compress_blocks(blocks, order)
        for b, s in enumerate(st):
            assert s == arith.compress(blocks[b], order), (order, b)
        back = dist.arith_uncompress_blocks(st)
        for b in range(len(blocks)):
            assert back[b] == blocks[b].tobytes(), (order, b)

    jobs = []
    for k in range(3):
        lens = [50, 50, 60, 40][: 3 + k % 2]
        data = (rng.integers(0, 30, sum(lens)) + 5).astype(np.uint8)
        jobs.append((data.tobytes(), lens))
    st = dist.fqz_compress_blocks(jobs)
    for k, s in enumerate(st):
        assert s == fqz.compress(jobs[k][0], jobs[k][1]), k
    back = dist.fqz_decompress_blocks(st)
    for k in range(len(jobs)):
        assert back[k] == jobs[k][0], k

    names = [b"".join(b"read%d.%d/%d\n" % (j, j * 7 % 13, 1 + (j & 1))
                      for j in range(40)) for _ in range(3)]
    st = dist.tok3_encode_blocks(names, level=5)
    for k, s in enumerate(st):
        assert s == tok3.encode_names(names[k], 5), k
    back = dist.tok3_decode_blocks(st)
    for k in range(len(names)):
        # decode_names emits \0-separated names (reference semantics)
        assert back[k] == names[k].replace(b"\n", b"\x00"), k
    offs, total = dist.archive_offsets([len(s) for s in st])
    assert total == sum(len(s) for s in st)
