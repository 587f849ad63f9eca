#!/usr/bin/env python
"""Smoke run of the batched CRAM codec path on one CUDA GPU.

    python chip_smoke.py [--seed N]     # one card: phases a-e
    python chip_smoke.py --multi        # four cards: phases a and f

Drives the main path once, through the entry points a CRAM writer or
reader calls (``models.batch``, ``parallel.streaming``,
``parallel.distributed``), at real block sizes, and checks every
stream byte for byte against the native C host coder built from
``htscodecs_tpu/native/hostkernels.c``, decoded output against the
input, and samples against the pure-Python oracles.  Data is generated
from ``--seed``.

Phases:
  a  device and setup: card name and power limit, JAX's device, the
     native library, the compile cache;
  b  rANS 4x16 orders 0/1 through models.batch at three widths:
     12,288 x 64 KiB NovaSeq-like (A ~ 4), 4,096 x 64 KiB Illumina-like
     (A ~ 40), 1,024 x 64 KiB long-read (A ~ 90);
  c  the Pallas kernel (ops/rans_gpu.py) against the XLA scans
     (ops/rans_v2.py), device-only and end to end, in turns;
  d  order 193, 4-way STRIPE, rANS 4x8, arith (engine="device") and
     StreamEncoder on a few hundred 64 KiB blocks;
  e  the tests marked `gpu`, in a child process before this one opens
     the card;
  f  (--multi only) parallel.distributed over a 4-card and a 1-card
     mesh on 4 x 3,072 NovaSeq-like blocks, streams compared with each
     other and with the host coder.

Exits non-zero when JAX finds no GPU, when it runs without the rest of
the repository, or when any phase fails.  The last line of standard
output is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
N = 65536


def result_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def log(*parts) -> None:
    print(*parts, flush=True)


def card_name_and_power() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if r.returncode:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# data, generated from the seed

def novaseq(B: int, n: int, rng):
    """NovaSeq-like binned qualities: 4 values in geometric runs (the
    distribution of bench.synth_quality, vectorised)."""
    import numpy as np
    syms = np.array([2, 12, 23, 37], np.uint8) + 33
    out = np.empty((B, n), np.uint8)
    for c0 in range(0, B, 512):
        nb = min(512, B - c0)
        runs = n // 2
        vals = rng.choice(4, size=(nb, runs), p=[0.05, 0.10, 0.15, 0.70])
        lens = rng.geometric(0.25, size=(nb, runs)).clip(1, 60)
        ends = np.cumsum(lens, axis=1)
        if (ends[:, -1] < n).any():
            raise RuntimeError("run generator fell short of a block")
        lens = np.where(ends > n, np.maximum(lens - (ends - n), 0), lens)
        out[c0:c0 + nb] = syms[np.repeat(vals.ravel(),
                                         lens.ravel())].reshape(nb, n)
    return out


def illumina(B: int, n: int, rng, read_len: int = 150):
    """Illumina-like qualities 2..41 in 150-base reads: a decaying
    per-position mean, per-read offsets, noise and rare drops to 2."""
    import numpy as np
    nreads = -(-n // read_len)
    pos = np.arange(read_len)
    mean = 38.0 - 12.0 * (pos / read_len) ** 2
    out = np.empty((B, n), np.uint8)
    for c0 in range(0, B, 256):
        nb = min(256, B - c0)
        q = (mean + rng.normal(0, 5, (nb, nreads, 1))
             + rng.normal(0, 5, (nb, nreads, read_len)))
        q[rng.random(q.shape) < 0.02] = 2
        q = np.rint(q).clip(2, 41).astype(np.uint8) + 33
        out[c0:c0 + nb] = q.reshape(nb, -1)[:, :n]
    return out


def longread(B: int, n: int, rng):
    """Long-read qualities over 0..88 (89 symbols, 90 with the symbol 0
    every table carries): a drifting mean per 64-base window plus
    noise, so nearly every block uses the whole range."""
    import numpy as np
    out = np.empty((B, n), np.uint8)
    for c0 in range(0, B, 256):
        nb = min(256, B - c0)
        base = rng.normal(45, 18, (nb, n // 64, 1)).clip(0, 88)
        x = (base + rng.normal(0, 6, (nb, n // 64, 64))).clip(0, 88)
        out[c0:c0 + nb] = np.rint(x).astype(np.uint8).reshape(nb, n) + 33
    return out


# ---------------------------------------------------------------------------
# helpers

def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def block(x):
    import jax
    return jax.block_until_ready(x)


def host_compress(blocks, order: int, codec: str = "rans4x16"):
    from htscodecs_tpu.models import arith, batch, rans4x8, rans4x16
    mod = {"rans4x16": rans4x16, "rans4x8": rans4x8, "arith": arith}[codec]
    return batch._pmap(lambda b: mod.compress(b, order), list(blocks))


def count_diff(got, want) -> int:
    if len(got) != len(want):
        return max(len(got), len(want))
    return sum(bytes(g) != bytes(w) for g, w in zip(got, want))


def count_decode_diff(got, blocks) -> int:
    return sum(g != blocks[i].tobytes() for i, g in enumerate(got))


def oracle_decode(stream: bytes) -> bytes:
    """Decode one rANS 4x16 stream with the pure-Python oracle
    (ops/rans_core.py) instead of the native coder."""
    from htscodecs_tpu.models import rans4x16
    saved = rans4x16._USE_NATIVE
    rans4x16._USE_NATIVE = False
    try:
        return rans4x16.uncompress(stream)
    finally:
        rans4x16._USE_NATIVE = saved


def mem(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"args {m.argument_size_in_bytes / 1e9:.3f} GB, "
            f"out {m.output_size_in_bytes / 1e9:.3f} GB, "
            f"temp {m.temp_size_in_bytes / 1e9:.3f} GB")


def peak_gb() -> float:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def interpret() -> bool:
    """Direct kernel calls follow the engine choice, so that the phases
    can be rehearsed on the CPU under rans_v2.using_engine("interpret")."""
    from htscodecs_tpu.ops import rans_v2
    return rans_v2.engine() == "interpret"


def device_tables(jb, order: int):
    """(alpha, packed, shiftv) on device, as models.batch builds them."""
    import jax.numpy as jnp
    from htscodecs_tpu.ops import tables_v2
    if order == 1:
        alpha, packed, _fh, meta, _H, _A = tables_v2.build_o1_device_async(jb)
        return alpha, packed, meta[:, 1]
    alpha, packed, _asz, _fh, _A = tables_v2.build_o0_device(jb)
    return alpha, packed, jnp.full((jb.shape[0],), 12, jnp.int32)


# ---------------------------------------------------------------------------
# phases

def phase_a():
    import jax
    from htscodecs_tpu._device import configure_cache, gpu_device
    device = gpu_device()
    from htscodecs_tpu import native
    if native.get_lib() is None:
        raise RuntimeError("native host coder did not build or load")
    from htscodecs_tpu.ops import rans_v2
    log(f"jax {jax.__version__}; device {device['kind']} x"
        f"{device['count']}; compile cache {configure_cache()}; "
        f"rANS engine {rans_v2.engine()}")
    return device


WIDTHS = (("novaseq_A4", 12288, novaseq), ("illumina_A40", 4096, illumina),
          ("longread_A90", 1024, longread))


def phase_b(batches):
    """rANS 4x16 through models.batch at the three widths."""
    from htscodecs_tpu.models import batch
    from htscodecs_tpu.ops import rans_gpu, tables_v2
    import jax.numpy as jnp
    bad = 0
    times = {}
    for name, blocks in batches.items():
        B = blocks.shape[0]
        mb = blocks.nbytes / 1e6
        jb = jnp.asarray(blocks)
        A = tables_v2._round_a(int(tables_v2._presence_jit(jb)[1]))
        log(f"[b] {name}: B={B} x {N} B ({mb:.0f} MB), padded A={A}")
        for order in (0, 1):
            t_first, dev = timed(lambda: batch.compress_blocks(
                blocks, order, engine="device"))
            t_enc, dev = timed(lambda: batch.compress_blocks(
                blocks, order, engine="device"))
            host = host_compress(blocks, order)
            nd = count_diff(dev, host)
            t_dfirst, back = timed(lambda: batch.uncompress_blocks(
                host, engine="device"))
            t_dec, back = timed(lambda: batch.uncompress_blocks(
                host, engine="device"))
            nb = count_decode_diff(back, blocks)
            k = B // 2
            ok_oracle = oracle_decode(host[k]) == blocks[k].tobytes()
            ratio = sum(map(len, host)) / blocks.nbytes
            bad += nd + nb + (not ok_oracle)
            times[(name, order)] = (t_enc, t_dec)
            log(f"[b] {name} o{order}: ratio {ratio:.4f}; device streams "
                f"differing from native C {nd}/{B}; device decode of the "
                f"native streams (= device streams when 0 differ) "
                f"mismatches {nb}/{B}; Python oracle decode of block {k} "
                f"{'exact' if ok_oracle else 'WRONG'}")
            log(f"[b] {name} o{order}: encode {t_enc:.3f} s "
                f"({mb / t_enc:.0f} MB/s), decode {t_dec:.3f} s "
                f"({mb / t_dec:.0f} MB/s), transfers included; compile "
                f"~{t_first - t_enc:.1f} s enc, ~{t_dfirst - t_dec:.1f} s dec")
            alpha, packed, sh = device_tables(jb, order)
            if order == 1:
                pres = tables_v2._presence_jit(jb)[0]
                tile = min(B, tables_v2.TILE)
                c = tables_v2._build_o1_jit.lower(
                    jb[:tile], pres[:tile], alpha.shape[1], N).compile()
                log(f"[b] {name} o1 table build (tile {tile}): {mem(c)}")
            itp = interpret()
            ce = rans_gpu.enc.lower(jb, alpha, packed, sh, order,
                                    interpret=itp).compile()
            st, w, n = rans_gpu.enc(jb, alpha, packed, sh, order,
                                    interpret=itp)
            cd = rans_gpu.dec.lower(st, w, packed, alpha, sh, N, order,
                                    interpret=itp).compile()
            log(f"[b] {name} o{order} kernel encode: {mem(ce)}")
            log(f"[b] {name} o{order} kernel decode: {mem(cd)}")
            del st, w, n, alpha, packed, sh, dev, host, back
        log(f"[b] {name}: peak_bytes_in_use {peak_gb():.2f} GB")
        del jb
    if bad:
        raise RuntimeError(f"phase b: {bad} mismatches")
    return times


def phase_c(batches, times_kernel):
    """Kernel against the XLA scans, one card, in turns."""
    import functools
    import jax
    from htscodecs_tpu.models import batch
    from htscodecs_tpu.ops import rans_gpu, rans_v2
    import jax.numpy as jnp
    order = 1
    itp = interpret()
    keng = rans_v2.engine()
    for name, blocks in batches.items():
        mb = blocks.nbytes / 1e6
        jb = jnp.asarray(blocks)
        alpha, packed, sh = device_tables(jb, order)
        enc_k = functools.partial(rans_gpu.enc, order=order, interpret=itp)

        def enc_x(jb, alpha, packed, sh):
            for cap in (rans_v2.SEG_CAP, rans_v2.SEG_CAP2, rans_v2.SEG):
                r = rans_v2._enc_scan_v2_pb(jb, alpha, packed, sh, order,
                                            seg_cap=cap,
                                            **rans_v2.get_enc_variant())
                if not bool(r[3]):
                    return r[:3]
            raise RuntimeError("XLA encode overflowed every tier")

        st, w, n = block(enc_k(jb, alpha, packed, sh))
        sx, wx, nx = block(enc_x(jb, alpha, packed, sh))
        same = bool(jnp.all(st == sx) & jnp.all(n == nx))
        w = w[:, :int(jnp.max(n))]
        with rans_v2.using_engine("xla"):
            dec_x = jax.jit(lambda *a: rans_v2.dec_words_pb(*a, N, order))
            block(dec_x(st, w, packed, alpha, sh))
        dec_k = jax.jit(lambda *a: rans_gpu.dec(*a, N, order,
                                                interpret=itp))
        out = block(dec_k(st, w, packed, alpha, sh))
        nbad = int(jnp.sum(out != jb))
        res = {"enc": {"kernel": [], "xla": []},
               "dec": {"kernel": [], "xla": []}}
        for eng in ("kernel", "xla", "xla", "kernel"):
            fe = enc_k if eng == "kernel" else enc_x
            fd = dec_k if eng == "kernel" else dec_x
            res["enc"][eng].append(timed(
                lambda: block(fe(jb, alpha, packed, sh)))[0])
            res["dec"][eng].append(timed(
                lambda: block(fd(st, w, packed, alpha, sh)))[0])
        for d in ("enc", "dec"):
            k, x = min(res[d]["kernel"]), min(res[d]["xla"])
            log(f"[c] {name} o1 {d} device-only: kernel "
                f"{res[d]['kernel']} s, XLA scan {res[d]['xla']} s; "
                f"best {mb / k:.0f} vs {mb / x:.0f} MB/s ({x / k:.1f}x)")
        del st, w, n, sx, wx, nx, out, alpha, packed, sh, jb
        # end to end through models.batch, the engines in turns
        host = host_compress(blocks, order)
        e2e = {"kernel": [], "xla": []}
        for eng in ("xla", "kernel", "xla", "xla", "kernel"):
            with rans_v2.using_engine(keng if eng == "kernel" else eng):
                t_enc, streams = timed(lambda: batch.compress_blocks(
                    blocks, order, engine="device"))
                t_dec, back = timed(lambda: batch.uncompress_blocks(
                    streams, engine="device"))
            nbad += count_diff(streams, host) + count_decode_diff(back,
                                                                  blocks)
            e2e[eng].append((round(t_enc, 3), round(t_dec, 3)))
        e2e["xla"] = e2e["xla"][1:]          # the first one compiled
        e2e["kernel"].append(tuple(round(t, 3)
                                   for t in times_kernel[(name, order)]))
        log(f"[c] {name} o1 end to end through models.batch, (encode s, "
            f"decode s): kernel {e2e['kernel']}, XLA {e2e['xla']}")
        if nbad or not same:
            raise RuntimeError(f"phase c {name}: engines disagree "
                               f"({nbad} mismatches, states equal {same})")


def phase_d(rng):
    """The rest of the path on a few hundred 64 KiB blocks."""
    from htscodecs_tpu.models import arith, batch, rans4x8, rans4x16
    from htscodecs_tpu.parallel.streaming import StreamEncoder
    blocks = illumina(256, N, rng)
    bad = 0
    cases = [("rans4x16 o193", 193), ("rans4x16 STRIPE4 o1",
                                      rans4x16.X_STRIPE | 1 | (4 << 8))]
    for label, order in cases:
        t, dev = timed(lambda: batch.compress_blocks(blocks, order,
                                                     engine="device"))
        nd = count_diff(dev, host_compress(blocks, order))
        nb = count_decode_diff(batch.uncompress_blocks(dev, engine="device"),
                               blocks)
        bad += nd + nb
        log(f"[d] {label}: {len(blocks)} blocks, differing from native C "
            f"{nd}, decode mismatches {nb} ({t:.2f} s encode)")
    for order in (0, 1):
        t, dev = timed(lambda: batch.r4x8_compress_blocks(
            blocks, order, engine="device"))
        nd = count_diff(dev, host_compress(blocks, order, "rans4x8"))
        nb = count_decode_diff(
            batch.r4x8_uncompress_blocks(dev, engine="device"), blocks)
        bad += nd + nb
        log(f"[d] rans4x8 o{order}: differing from native C {nd}, decode "
            f"mismatches {nb} ({t:.2f} s encode)")
    ablocks = blocks
    for order in (0, 1):
        t, dev = timed(lambda: batch.arith_compress_blocks(
            ablocks, order, engine="device"))
        nd = count_diff(dev, [arith.compress(b, order) for b in ablocks])
        nb = count_decode_diff(
            batch.arith_uncompress_blocks(dev, engine="device"), ablocks)
        bad += nd + nb
        log(f"[d] arith o{order}: {len(ablocks)} blocks, differing from "
            f"native C {nd}, decode mismatches {nb} ({t:.2f} s encode)")
    def stream():
        enc = StreamEncoder(order=1, depth=2, assemble=True)
        got = []
        for k in range(0, len(blocks), 64):
            enc.submit(blocks[k:k + 64])
            for r in enc.drain_ready():
                got += r
        for r in enc.finish():
            got += r
        return got

    t_first, got = timed(stream)
    t, got = timed(stream)
    nd = count_diff(got, host_compress(blocks, 1))
    bad += nd
    t1, _ = timed(lambda: batch.compress_blocks(blocks, 1, engine="device"))
    log(f"[d] StreamEncoder o1 assemble=True: 4 batches of 64, differing "
        f"from native C {nd}; {t:.3f} s ({t_first:.2f} s first call), "
        f"one-shot compress_blocks of the same blocks {t1:.3f} s")
    if bad:
        raise RuntimeError(f"phase d: {bad} mismatches")


def phase_e():
    """Tests marked `gpu`, in a child, before this process opens the
    card (one JAX process per card)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", str(REPO / "tests")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1:] or [""]
    log(f"[e] pytest -m gpu: rc {r.returncode}; {tail[0]}")
    if r.returncode:
        log(r.stdout[-4000:] + r.stderr[-2000:])
        raise RuntimeError("phase e: tests marked gpu failed")


def phase_f(rng):
    """parallel.distributed over all cards and over one card."""
    import jax
    from htscodecs_tpu.models import rans4x8, rans4x16
    from htscodecs_tpu.parallel import distributed as dist
    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--multi needs 4 cards, found {len(devs)}")
    blocks = novaseq(4 * 3072, N, rng)
    mb = blocks.nbytes / 1e6
    mesh4 = dist.block_mesh("b", devs[:4])
    mesh1 = dist.block_mesh("b", devs[:1])
    pres = dist._presence_fn(mesh4)(dist._to_global(blocks, mesh4))[0]
    log("[f] shards of a 4-card shard_map output: " + ", ".join(
        f"rows {s.index[0].start}-{s.index[0].stop} on {s.device}"
        for s in pres.addressable_shards))
    bad = 0
    for label, comp, dec, hostmod in (
            ("rans4x16 o1", dist.compress_blocks, dist.uncompress_blocks,
             rans4x16),
            ("rans4x8 o1", dist.r4x8_compress_blocks,
             dist.r4x8_uncompress_blocks, rans4x8)):
        res = {}
        for mname, mesh in (("4-card", mesh4), ("1-card", mesh1)):
            tc, streams = timed(lambda: comp(blocks, 1, mesh,
                                             engine="device"))
            te, streams = timed(lambda: comp(blocks, 1, mesh,
                                             engine="device"))
            tdc, back = timed(lambda: dec(streams, mesh=mesh,
                                          engine="device"))
            td, back = timed(lambda: dec(streams, mesh=mesh,
                                         engine="device"))
            nb = count_decode_diff(back, blocks)
            bad += nb
            res[mname] = streams
            log(f"[f] {label} {mname} mesh: encode {te:.3f} s "
                f"({mb / te:.0f} MB/s), decode {td:.3f} s "
                f"({mb / td:.0f} MB/s), decode mismatches {nb}; first "
                f"calls (compiling) {tc:.1f} s / {tdc:.1f} s")
        host = host_compress(blocks, 1, hostmod.__name__.split(".")[-1])
        n41 = count_diff(res["4-card"], res["1-card"])
        n4h = count_diff(res["4-card"], host)
        bad += n41 + n4h
        log(f"[f] {label}: 4-card vs 1-card streams differing {n41}/"
            f"{len(blocks)}; 4-card vs native C differing {n4h}")
    if bad:
        raise RuntimeError(f"phase f: {bad} mismatches")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card distributed phase")
    args = ap.parse_args(argv)
    if not (REPO / "htscodecs_tpu" / "__init__.py").exists():
        log("chip_smoke.py must run from a checkout of the repository")
        return 2
    sys.path.insert(0, str(REPO))
    failed = []

    def run(label, fn, *a):
        t0 = time.perf_counter()
        try:
            out = fn(*a)
        except Exception:
            traceback.print_exc()
            failed.append(label)
            log(f"phase {label}: FAILED after "
                f"{time.perf_counter() - t0:.1f} s")
            return None
        log(f"phase {label}: ok ({time.perf_counter() - t0:.1f} s)")
        return out

    # the card's name and power limit come from a child process before
    # anything here touches JAX; then the tests marked gpu get the card
    try:
        log(card_name_and_power())
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log(f"phase a: FAILED: no card ({e})")
        return 1
    if not args.multi:
        run("e", phase_e)
    device = run("a", phase_a)
    if device is None:
        return 1
    import numpy as np
    rng = np.random.default_rng(args.seed)
    if args.multi:
        run("f", phase_f, rng)
    else:
        t0 = time.perf_counter()
        batches = {name: gen(B, N, rng) for name, B, gen in WIDTHS}
        log(f"data generated in {time.perf_counter() - t0:.1f} s")
        times = run("b", phase_b, batches)
        if times is not None:
            run("c", phase_c, batches, times)
        run("d", phase_d, rng)
    if failed:
        log(f"failed phases: {' '.join(failed)}")
        return 1
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
