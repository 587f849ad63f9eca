"""The Pallas rANS 4x16 kernel (ops/rans_gpu.py) and its routing.

On the CPU the kernel runs under the Pallas interpreter and is checked
against the XLA scans (ops/rans_v2.py) and the native C coder; tests
marked `gpu` compile it for the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from htscodecs_tpu import native
from htscodecs_tpu.models import batch, rans4x16
from htscodecs_tpu.ops import rans_gpu, rans_v2, tables_v2


def _tables(rng, B, A, order, shifts):
    """Random dense tables in which every symbol of every context has a
    nonzero frequency, normalised to 1 << shift per block."""
    rows = A if order == 1 else 1
    packed = np.zeros((B, rows, A), np.int32)
    for b in range(B):
        tot = 1 << int(shifts[b])
        for r in range(rows):
            w = rng.random(A) + 0.05
            f = np.maximum(np.floor(w / w.sum() * tot).astype(np.int64), 1)
            f[np.argmax(f)] += tot - f.sum()
            base = np.cumsum(f) - f
            packed[b, r] = (base << rans_v2.PACK_SHIFT) | f
    alpha = np.broadcast_to(
        (np.arange(A) * 2 + 1).astype(np.uint8), (B, A)).copy()
    return alpha, packed if order == 1 else packed[:, 0]


def _xla_enc(blocks, alpha, packed, shiftv, order):
    for cap in (rans_v2.SEG_CAP, rans_v2.SEG_CAP2, rans_v2.SEG):
        st, w, n, ovf = rans_v2._enc_scan_v2_pb(
            blocks, alpha, packed, shiftv, order, seg_cap=cap)
        if not bool(ovf):
            return np.asarray(st), np.asarray(w), np.asarray(n)
    raise AssertionError("XLA encode overflowed every tier")


def _check_against_xla(order, A, shifts, N, B=10, seed=0):
    interpret = jax.default_backend() != "gpu"
    rng = np.random.default_rng(seed)
    alpha, packed = _tables(rng, B, A, order, shifts)
    blocks = alpha[0][rng.integers(0, A, (B, N))]
    args = tuple(map(jnp.asarray, (blocks, alpha, packed, shifts)))
    st, w, n = map(np.asarray, rans_gpu.enc(*args, order,
                                            interpret=interpret))
    sx, wx, nx = _xla_enc(*args, order)
    np.testing.assert_array_equal(st, sx)
    np.testing.assert_array_equal(n, nx)
    for b in range(B):
        np.testing.assert_array_equal(w[b, :n[b]], wx[b, :n[b]])
    out = rans_gpu.dec(jnp.asarray(st), jnp.asarray(w[:, :n.max()]),
                       args[2], args[1], args[3], N, order,
                       interpret=interpret)
    np.testing.assert_array_equal(np.asarray(out), blocks)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shift", [10, 12])
@pytest.mark.parametrize("A", [4, 48, 90])
def test_kernel_matches_xla_scan(order, shift, A):
    """Orders, table precisions and alphabet widths: B = 10 blocks in
    programs of BPP = 8, so the last program is padded."""
    _check_against_xla(order, A, np.full(10, shift, np.int32), N=71)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("tail", [0, 1, 2, 3])
def test_kernel_tails(order, tail):
    """Every N % 4: the order-1 lane-3 tail and the order-0 last step."""
    _check_against_xla(order, 8, np.full(6, 12, np.int32), N=64 + tail,
                       B=6, seed=tail)


@pytest.mark.parametrize("order", [0, 1])
def test_kernel_mixed_shifts(order):
    shifts = np.array([10, 12] * 5, np.int32)
    _check_against_xla(order, 16, shifts, N=90, seed=3)


def _native_tables(blocks, order):
    if order == 1:
        res = [native.build_tables_o1_dense(b) for b in blocks]
        alpha, packed, _A = rans_v2.densify_builds((r[1], r[2]) for r in res)
        shifts = np.array([r[3] for r in res], np.int32)
    else:
        res = [native.build_tables_o0(b) for b in blocks]
        alpha, packed, _A = rans_v2.densify_group_o0(
            np.stack([r[2] for r in res]), np.stack([r[1] for r in res]))
        shifts = np.full(len(blocks), 12, np.int32)
    return alpha, packed, shifts


def _qualities(rng, B, N, A):
    lo = rng.integers(0, A, (B, N // 8 + 1, 1))
    x = (lo + rng.integers(-2, 3, (B, N // 8 + 1, 8))).clip(0, A - 1)
    return (x.reshape(B, -1)[:, :N] + 33).astype(np.uint8)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("A", [4, 48, 90])
def test_kernel_matches_native_coder(order, A):
    """Streams equal the native C coder's payloads byte for byte."""
    if not native.available():
        pytest.skip("native host coder unavailable")
    rng = np.random.default_rng(A + order)
    B, N = 9, 203
    blocks = _qualities(rng, B, N, A)
    alpha, packed, shifts = _native_tables(blocks, order)
    st, w, n = map(np.asarray, rans_gpu.enc(
        *map(jnp.asarray, (blocks, alpha, packed, shifts)), order,
        interpret=True))
    for b in range(B):
        body = (rans4x16._compress_o1 if order else
                rans4x16._compress_o0)(blocks[b])
        payload = st[b].astype("<u4").tobytes() + \
            w[b, :n[b]].astype("<u2").tobytes()
        assert body.endswith(payload), b


@pytest.fixture
def interpret_engine():
    with rans_v2.using_engine("interpret"):
        yield


def test_engine_default_follows_backend():
    assert rans_v2.engine() == ("kernel" if jax.default_backend() == "gpu"
                                else "xla")
    with pytest.raises(ValueError):
        with rans_v2.using_engine("vmem"):
            pass
    with rans_v2.using_engine("xla"):
        with rans_v2.using_engine("interpret"):
            assert rans_v2.engine() == "interpret"
        assert rans_v2.engine() == "xla"


@pytest.mark.parametrize("order", [0, 1])
def test_models_batch_routes_to_kernel(interpret_engine, order):
    """compress_blocks/uncompress_blocks through the kernel: the device
    table build, the kernel encode and the kernel decode."""
    rng = np.random.default_rng(11 + order)
    blocks = _qualities(rng, 16, 256, 6)
    streams = batch.compress_blocks(list(blocks), order, engine="device")
    assert streams == [rans4x16.compress(b, order) for b in blocks]
    back = batch.uncompress_blocks(streams, engine="device")
    assert back == [b.tobytes() for b in blocks]


def test_streaming_routes_to_kernel(interpret_engine):
    from htscodecs_tpu.parallel.streaming import StreamEncoder
    rng = np.random.default_rng(5)
    blocks = _qualities(rng, 16, 256, 12)
    enc = StreamEncoder(order=1, depth=2)
    got = []
    for k in (0, 8):
        enc.submit(blocks[k:k + 8])
        for r in enc.drain_ready():
            got += r
    for r in enc.finish():
        got += r
    assert got == [rans4x16.compress(b, 1) for b in blocks]


def test_bigram_hist_paths_agree():
    """The one-hot einsum (A <= 8) and the scatter-add give the same
    exact counts."""
    rng = np.random.default_rng(2)
    for A in (4, 8):
        dense = jnp.asarray(rng.integers(0, A, (3, 300)), jnp.int32)
        ctx = jnp.concatenate([jnp.zeros((3, 1), jnp.int32), dense[:, :-1]],
                              axis=1)
        h1 = tables_v2._bigram_hist(ctx, dense, A)
        h2 = tables_v2._scatter_hist(ctx * A + dense, 3, A * A).reshape(
            3, A, A)
        np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))


def test_densify_maps_bytes_to_alphabet_rank():
    alpha = jnp.asarray([[3, 7, 9, 9], [0, 1, 2, 200]], jnp.uint8)
    blocks = jnp.asarray([[9, 3, 7], [200, 0, 2]], jnp.uint8)
    np.testing.assert_array_equal(
        np.asarray(rans_v2._densify(blocks, alpha)), [[2, 0, 1], [3, 0, 2]])


@pytest.mark.gpu
@pytest.mark.parametrize("order", [0, 1])
def test_kernel_on_gpu_matches_xla_scan(gpu, order):
    """The kernel as compiled for the card, against the XLA scans, at a
    batch of several programs with mixed table precisions."""
    _check_against_xla(order, 48, np.array([10, 12] * 40, np.int32),
                       N=4099, B=80, seed=order)


@pytest.mark.gpu
def test_models_batch_uses_kernel_on_gpu(gpu):
    assert rans_v2.engine() == "kernel"
    rng = np.random.default_rng(9)
    blocks = _qualities(rng, 32, 65536, 40)
    for order in (0, 1):
        streams = batch.compress_blocks(list(blocks), order, engine="device")
        assert streams == [rans4x16.compress(b, order) for b in blocks]
        assert batch.uncompress_blocks(streams, engine="device") == \
            [b.tobytes() for b in blocks]
