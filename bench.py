#!/usr/bin/env python
"""Headline benchmark: rANS 4x16 order-1 encode+decode on one GPU.

Batch-scale analog of the reference test tools' ``-t`` mode (timed
enc/dec passes over the same data, MB/s) over a corpus table:

- ``synth4``   G unique synthetic NovaSeq-like 64 KiB quality blocks
               (A=4, run-structured) tiled to B blocks — the headline,
               comparable across rounds.
- ``distinct`` B unique synthetic blocks (no tiling): device-verify
               evidence on all-distinct data.
- ``q8`` / ``q40dir``  real `tests/dat` quality data tiled to B —
               A≈8 and A≈40+ alphabets, the reference's own corpus.

Accounting per corpus: pipelined wall time, the way a production
encoder runs —
- t_enc = one pass of: on-device table build (ops/tables_v2.py) ->
  async per-block-shift encode dispatch -> host header-frequency D2H +
  batched native header serialization OVERLAPPING the running encode
  -> sync.
- t_dec = one pass of: async decode dispatch -> real host parse of
  every block header overlapping it -> sync.
- H2D/D2H staging of payload data is excluded (the C tool's -t
  likewise excludes file IO).  Correctness is verified ON DEVICE
  (mismatch count) plus a one-block byte-exact readback against the
  native host encoder.
- BASELINE_AGG_MBPS is the single-threaded C reference's order-1
  aggregate 2*bytes/(t_enc+t_dec) on q40 data, taken from BASELINE.md.

Exits non-zero, printing no number, when JAX finds no GPU.  Prints one
JSON line: {"metric", "value", "unit", "vs_baseline", "device"} for
the headline corpus; the full corpus table goes to stderr.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np

# Set HTSCODECS_TPU_BENCH_PROFILE=1 (or =/path/to/tracedir) to capture
# a jax.profiler trace of one steady-state pass per corpus (default
# directory: build/jax_trace_bench in the checkout).
PROFILE = os.environ.get("HTSCODECS_TPU_BENCH_PROFILE", "")
BASELINE_AGG_MBPS = 200.0

# Autotuned variant winners, cached per padded-alphabet bucket so the
# corpora sharing a regime don't recompile the whole candidate set
# (compiles dominate the driver's bench budget).
_TUNE_CACHE: dict = {}
# HTSCODECS_TPU_BENCH_QUICK=1: tiny shapes for a full-path dress
# rehearsal (CPU-friendly); numbers are meaningless, plumbing is real.
QUICK = os.environ.get("HTSCODECS_TPU_BENCH_QUICK", "") == "1"
B = 256 if QUICK else 12288
G = 8
N = 2048 if QUICK else 65536
REPS = 3
DAT = pathlib.Path("/root/reference/tests/dat")


def synth_quality(n_blocks, n, seed=42):
    """NovaSeq-like 4-symbol quality stream with runs."""
    rng = np.random.default_rng(seed)
    syms = np.array([2, 12, 23, 37], np.uint8) + 33
    out = np.empty((n_blocks, n), np.uint8)
    for b in range(n_blocks):
        vals = rng.choice(4, size=n // 8, p=[0.05, 0.10, 0.15, 0.70])
        lens = rng.geometric(0.25, size=n // 8).clip(1, 60)
        seq = np.repeat(vals, lens)[:n]
        if len(seq) < n:
            seq = np.pad(seq, (0, n - len(seq)), constant_values=3)
        out[b] = syms[seq]
    return out


def tile_file(path, n_blocks, n):
    raw = np.frombuffer(path.read_bytes(), np.uint8)
    nb = max(len(raw) // n, 1)
    base = raw[:nb * n]
    if len(base) < n:
        base = np.pad(raw, (0, n - len(raw)), constant_values=raw[-1])
        nb = 1
    uniq = base.reshape(nb, n)
    reps = -(-n_blocks // nb)
    return np.tile(uniq, (reps, 1))[:n_blocks]


def _trace_dir():
    return PROFILE if PROFILE not in ("", "1") else str(
        pathlib.Path(__file__).resolve().parent / "build" / "jax_trace_bench")


def _stream_enc_probe(name, blocks, jb):
    """Pipelined streaming encode (parallel/streaming.py): batch k's
    host work (meta/freq D2H, header serialization) overlaps batch
    k+1's device work — how a production CRAM writer drives the codec
    (the reference test tools likewise loop blocks through one open
    stream).  Returns (per-corpus-pass seconds, verify_fn) or None.

    Accounting: one warm pass compiles; the timed run streams the
    corpus once (small corpora: 6 repeats) and reports wall time per
    corpus pass, steady-state.
    """
    from htscodecs_tpu.parallel.streaming import StreamEncoder
    from htscodecs_tpu.models import rans4x16
    from htscodecs_tpu import native

    Bc, Nc = blocks.shape
    # batches are pre-staged device slices: H2D staging is excluded
    # from the accounting exactly as in the one-shot pipeline
    if Bc <= 1024:
        batches = [jb] * (2 if QUICK else 6)
        host0 = blocks
        passes = len(batches)
    else:
        CH = 3072
        if Bc % CH:
            return None
        one = [jb[i:i + CH] for i in range(0, Bc, CH)]
        host0 = blocks[:CH]
        batches = one * 2
        passes = 2

    def run(keep_first):
        enc = StreamEncoder(order=1, depth=2, assemble=False)
        first = None
        t0 = time.time()
        for bt in batches:
            enc.submit(bt)
            for r in enc.drain_ready():
                if keep_first and first is None:
                    first = r
                del r
        for r in enc.finish():
            if keep_first and first is None:
                first = r
            del r
        return time.time() - t0, first

    _dt, first = run(True)            # warm (compiles) + verify output
    if first is None or not isinstance(first, tuple):
        return None                   # host fallback path: not a win

    # byte-exactness of the streamed output (one unflagged block vs
    # the independent host encoder), checked before the timed run so
    # the big device arrays can be dropped
    exact = None
    hdrs, st_d, w_d, counts, flag, _sh = first
    for chk in np.flatnonzero(np.asarray(flag) == 0)[:4]:
        chk = int(chk)
        body = rans4x16._compress_o1(host0[chk])
        blk_states = np.asarray(st_d[chk]).astype("<u4").tobytes()
        blk_words = np.asarray(
            w_d[chk, :counts[chk]]).astype("<u2").tobytes()
        off, *_t = native.parse_tables_o1(body)
        exact = (body[off:] == blk_states + blk_words
                 and hdrs[chk] == body[:off])
        break
    del first, hdrs, st_d, w_d
    if exact is False:
        return None

    dt, _ = run(False)
    return dt / passes, exact


def bench_corpus(name, blocks, check_exact=True):
    import jax
    import jax.numpy as jnp
    from htscodecs_tpu import native
    from htscodecs_tpu.ops import rans_v2, tables_v2
    from htscodecs_tpu.models import rans4x16
    from htscodecs_tpu.utils import varint

    Bc, Nc = blocks.shape
    total_mb = Bc * Nc / 1e6
    jb = jnp.asarray(blocks)

    # ---- pipelined encode: device table build -> async per-block-
    # shift encode scan -> host D2H of header freqs + serialization
    # OVERLAPPING the running scan (what a production encoder does) ---
    def table_stage():
        return tables_v2.build_o1_device_async(jb)

    def enc_pipeline(seg_cap, hdr_src="d2h"):
        t0 = time.time()
        st = table_stage()
        if st is None:
            return None
        alpha_d, packed_d, fhdr_d, meta_d, _H, _A = st
        parts = None
        sp = None
        if hdr_src == "s12":
            # sparse 12-bit transport: bitmap + nonzeros-compacted
            # values; tier-width prefix slices are enqueued BEFORE the
            # scan so their D2H rides the DMA path under it (a slice
            # enqueued after the scan would serialize behind it)
            bm_d, v12_d, _cnts, maxnz_d = tables_v2.pack_freqs_sparse12(
                fhdr_d)
            P = v12_d.shape[1] // 3
            tiers = sorted({max(P // 4, 1), max(P // 2, 1),
                            max((3 * P) // 4, 1), P})
            CH = -(-Bc // 4)
            sp_tiers = {}
            for tp in tiers:
                sl = v12_d[:, :3 * tp]
                sp_tiers[tp] = [sl[i:i + CH] for i in range(0, Bc, CH)]
            bm_parts = [bm_d[i:i + CH] for i in range(0, Bc, CH)]
            for pt in bm_parts:
                pt.copy_to_host_async()
            sp = (sp_tiers, bm_parts, maxnz_d, CH)
        if hdr_src == "p12":
            # 12-bit freq transport: dispatch the pack BEFORE the
            # encode scan (it must clear the compute stream first);
            # its chunked D2H then rides the DMA path UNDER the scan,
            # moving 25% less than the u16 form, and the native
            # serializer consumes each chunk as it lands
            ph = tables_v2.pack_freqs12(fhdr_d)
            CH = -(-Bc // 4)
            parts = [ph[i:i + CH] for i in range(0, Bc, CH)]
            for pt in parts:
                pt.copy_to_host_async()
        st_d, w_d, n_d, ovf = rans_v2.enc_scan_pb(
            jb, alpha_d, packed_d, meta_d[:, 1], 1, seg_cap=seg_cap)
        # host work below overlaps the dispatched device scan
        meta = np.asarray(meta_d)
        if hdr_src == "host":
            # serialize from host-rebuilt tables (bit-identical native
            # builder): skips the (B,A,A) u16 header-frequency D2H
            hdrs = [native.build_tables_o1_dense(blocks[b])[0]
                    for b in range(Bc)]
        elif hdr_src == "s12":
            alpha_h = np.asarray(alpha_d)
            Ap = int(alpha_d.shape[1])
            sp_tiers, bm_parts, maxnz_d, CH = sp
            mx = int(np.asarray(maxnz_d))       # ready after the pack
            need = -(-mx // 2)
            tp = min(t for t in sp_tiers if t >= need)
            for pt in sp_tiers[tp]:
                pt.copy_to_host_async()
            hdrs = []
            for k, (bp, vp) in enumerate(zip(bm_parts, sp_tiers[tp])):
                bm = np.asarray(bp)
                vv = np.asarray(vp)
                sl = slice(k * CH, k * CH + bm.shape[0])
                # C-side sparse consumer
                hdrs += native.serialize_o1_sparse12_batch(
                    alpha_h[sl], meta[sl, 0], bm, vv, meta[sl, 1])
        elif hdr_src == "p12":
            alpha_h = np.asarray(alpha_d)
            Ap = int(alpha_d.shape[1])
            CH = parts[0].shape[0]
            hdrs = []
            for k, pt in enumerate(parts):
                pk = np.asarray(pt)
                sl = slice(k * CH, k * CH + pk.shape[0])
                fr = tables_v2.unpack_freqs12_host(pk, Ap)
                hdrs += native.serialize_o1_dense_batch(
                    alpha_h[sl], meta[sl, 0], fr, meta[sl, 1])
        else:
            fhdr = np.asarray(fhdr_d)
            alpha_h = np.asarray(alpha_d)
            hdrs = native.serialize_o1_dense_batch(
                alpha_h, meta[:, 0], fhdr, meta[:, 1])
        np.asarray(jnp.sum(n_d))          # sync the scan
        dt = time.time() - t0
        return dt, meta, hdrs, alpha_d, packed_d, meta_d, st_d, w_d, \
            n_d, ovf

    # NOTE on liveness: each enc_pipeline result tuple holds >1 GB of
    # device arrays (words, states, tables): always del the previous
    # tuple before re-running.
    seg_cap = rans_v2.SEG_CAP
    for cap in (rans_v2.SEG_CAP, rans_v2.SEG_CAP2, rans_v2.SEG):
        seg_cap = cap
        _w = enc_pipeline(cap)
        if _w is None:
            return None                   # wide alphabet: declined
        _ovf = bool(np.asarray(_w[9]))
        A_pad = int(_w[4].shape[1])
        del _w
        if not _ovf:
            break

    # ---- autotune the header-frequency transport (byte-exact
    # variants; the encode itself is the engine rans_v2 selects).  Any
    # failure propagates: bench never times a stand-in ----
    if ("enc", A_pad, Bc) in _TUNE_CACHE:
        enc_hdr = _TUNE_CACHE[("enc", A_pad, Bc)]
    else:
        # header freqs are tiny at small A: D2H is free
        cands = ["d2h"] if A_pad <= 8 else ["d2h", "host", "s12", "p12"]
        ran = []           # (t, hd, hdrs)
        for hd_c in cands:
            enc_pipeline(seg_cap, hd_c)             # warm (compiles)
            _c = enc_pipeline(seg_cap, hd_c)
            t_c, h_c = _c[0], _c[2]
            del _c
            print(json.dumps({"tune": f"{name}:enc", "variant": hd_c,
                              "t_s": round(t_c, 3)}), file=sys.stderr,
                  flush=True)
            ran.append((t_c, hd_c, h_c))
        # every transport must serialize the same headers as the plain
        # u16 D2H (the first candidate)
        for t_c, hd_c, h_c in ran:
            if h_c != ran[0][2]:
                raise AssertionError(f"{name}: header transport {hd_c} "
                                     f"diverges from d2h")
        enc_hdr = min(ran, key=lambda r: r[0])[1]
        _TUNE_CACHE[("enc", A_pad, Bc)] = enc_hdr
    sc_best = seg_cap

    # streaming-pipeline candidate: overlaps batch k's host work with
    # batch k+1's device work (table build + transfer latencies hide)
    t_stream = None
    spr = _stream_enc_probe(name, blocks, jb)
    if spr is not None:
        t_stream, s_exact = spr
        print(json.dumps({"tune": f"{name}:enc", "variant": "stream",
                          "t_s": round(t_stream, 3), "exact": s_exact}),
              file=sys.stderr, flush=True)

    r = enc_pipeline(sc_best, enc_hdr)  # steady: best of two
    t_enc = r[0]
    del r
    r = enc_pipeline(sc_best, enc_hdr)
    t_enc = min(t_enc, r[0])
    (dt, meta, hdrs, alpha_d, packed_d, meta_d, st_d, w_d, n_d, ovf) = r
    enc_var = enc_hdr
    if t_stream is not None and t_stream < t_enc:
        t_enc = t_stream
        enc_var = "stream"
    assert not bool(np.asarray(ovf)), f"{name}: compaction overflow"
    if hdrs is None:
        return None
    shifts, flag = meta[:, 1], meta[:, 2]
    nflag = int(flag.sum())
    counts_all = np.asarray(n_d)

    # sub-measurement: device table build alone (no transfer/serialize)
    t0 = time.time()
    st = table_stage()
    np.asarray(jnp.sum(st[3]))
    t_tables = time.time() - t0

    # ---- pipelined decode: async decode dispatch with the real
    # host-side parse of every header overlapping it ----
    w_trim = w_d[:, :rans_v2.used_width(int(counts_all.max()),
                                        w_d.shape[1])]
    shiftv = meta_d[:, 1]

    def dec_pipeline():
        t0 = time.time()
        out = rans_v2.dec_words_pb(st_d, w_trim, packed_d, alpha_d,
                                   shiftv, Nc, 1)
        for h in hdrs:
            native.parse_tables_o1_dense(h + b"\x00" * 16)
        np.asarray(jnp.sum(out[:, :4].astype(jnp.uint32)))
        return time.time() - t0, out

    _w2, out = dec_pipeline()                 # warm (compiles)
    del out
    t_dec, out = dec_pipeline()
    del out
    dtd, out = dec_pipeline()
    t_dec = min(t_dec, dtd)

    if PROFILE:
        try:
            with jax.profiler.trace(_trace_dir()):
                enc_pipeline(sc_best, enc_hdr)
                dec_pipeline()
            print(json.dumps({"profile": f"{name}:trace",
                              "dir": _trace_dir()}),
                  file=sys.stderr, flush=True)
        except Exception as e:  # a trace is diagnostics, never worth
            # failing the bench over
            print(json.dumps({"profile": f"{name}:trace",
                              "error": str(e)[:200]}),
                  file=sys.stderr, flush=True)

    # ---- verify ----
    mism = int(np.asarray(jnp.sum(out != jb)))
    byte_exact = True
    exact_checked = False
    if check_exact:
        # sample unflagged blocks until one yields a plain order-1
        # reference stream (tiny blocks can CAT out); never report
        # byte_exact for a corpus where nothing was actually compared
        for chk in np.flatnonzero(flag == 0)[:8]:
            chk = int(chk)
            # direct O1 entropy body (header + payload): independent of
            # the wrapper's method search, so near-incompressible
            # corpora (uni64) that would CAT at small N still verify
            body = rans4x16._compress_o1(blocks[chk])
            blk_words = np.asarray(
                w_d[chk, :counts_all[chk]]).astype("<u2").tobytes()
            blk_states = np.asarray(st_d[chk]).astype("<u4").tobytes()
            off, *_t = native.parse_tables_o1(body)
            byte_exact = (body[off:] == blk_states + blk_words
                          and hdrs[chk] == body[:off])
            exact_checked = True
            break
        if not exact_checked:
            byte_exact = False

    return {
        "corpus": name,
        "enc_MBps": round(total_mb / t_enc, 1),
        "dec_MBps": round(total_mb / t_dec, 1),
        "agg_MBps": round(2 * total_mb / (t_enc + t_dec), 1),
        "tables_dev_s": round(t_tables, 2),
        "enc_pipe_s": round(t_enc, 2), "dec_pipe_s": round(t_dec, 2),
        "shifts": sorted(int(v) for v in np.unique(shifts)),
        "band_flags": nflag, "mismatches": mism,
        "byte_exact": bool(byte_exact),
        "exact_checked": bool(exact_checked) if check_exact else None,
        "engine": rans_v2.engine(), "hdr_transport": enc_var,
    }


def bench_fqz_tok3():
    """Secondary per-codec rows (host-side codecs; BASELINE.md lists
    fqzcomp/tok3 MB/s explicitly)."""
    import numpy as np
    rows = []
    qf = DAT / "q40+dir"
    if qf.exists():
        from htscodecs_tpu.models import fqz
        raw = qf.read_bytes() * (2 if QUICK else 20)
        # parse like the reference tool: qual column ASCII-33 shifted,
        # optional read2 flag column (feeding raw lines would widen the
        # alphabet past 64 and measure the wrong model path)
        lens, flags, arr = [], [], []
        for line in raw.split(b"\n"):
            if not line:
                continue
            parts = line.replace(b"\t", b" ").split(b" ")
            lens.append(len(parts[0]))
            r2 = int(parts[1]) if len(parts) > 1 and parts[1] else 0
            flags.append(r2 * fqz.FQZ_FREAD2)
            arr.append(np.frombuffer(parts[0], np.uint8))
        qual = np.concatenate(arr) - 33
        lens = np.array(lens, np.uint32)
        comp = fqz.compress(qual, lens, list(flags), strat=0)
        te = td = 1e9
        for _ in range(3):
            t0 = time.time()
            comp = fqz.compress(qual, lens, list(flags), strat=0)
            te = min(te, time.time() - t0)
        back = fqz.decompress(comp)
        for _ in range(3):
            t0 = time.time()
            back = fqz.decompress(comp)
            td = min(td, time.time() - t0)
        out = back[0] if isinstance(back, tuple) else back
        rows.append({
            "corpus": "fqz_q40dir_2MB",
            "enc_MBps": round(len(qual) / 1e6 / te, 1),
            "dec_MBps": round(len(qual) / 1e6 / td, 1),
            "roundtrip": bytes(out) == qual.tobytes(),
            "ratio": round(len(comp) / len(qual), 3),
        })
    if qf.exists():
        from htscodecs_tpu.models import arith
        data = (qf.read_bytes() * (2 if QUICK else 20))[:2000000]
        arr = np.frombuffer(data, np.uint8)
        comp = arith.compress(arr, 1)
        te = td = 1e9
        for _ in range(3):
            t0 = time.time()
            comp = arith.compress(arr, 1)
            te = min(te, time.time() - t0)
        back = arith.uncompress(comp)
        for _ in range(3):
            t0 = time.time()
            back = arith.uncompress(comp)
            td = min(td, time.time() - t0)
        rows.append({
            "corpus": "arith_o1_2MB",
            "enc_MBps": round(len(data) / 1e6 / te, 1),
            "dec_MBps": round(len(data) / 1e6 / td, 1),
            "roundtrip": bytes(back) == data,
            "ratio": round(len(comp) / len(data), 3),
        })
    from htscodecs_tpu.models import tok3
    rng = np.random.default_rng(0)
    nn = 5000 if QUICK else 100000
    xs = rng.integers(1000, 30000, nn)
    ys = rng.integers(1000, 30000, nn)
    tl = rng.integers(1101, 2316, nn)
    names = "\n".join(
        f"D00360:95:H2YWMBCXX:1:{t}:{x}:{y}"
        for t, x, y in zip(tl, xs, ys)).encode() + b"\n"
    comp = tok3.encode_names(names, level=9)
    te = td = 1e9
    for _ in range(3):
        t0 = time.time()
        comp = tok3.encode_names(names, level=9)
        te = min(te, time.time() - t0)
    back = tok3.decode_names(comp)
    for _ in range(3):
        t0 = time.time()
        back = tok3.decode_names(comp)
        td = min(td, time.time() - t0)
    rows.append({
        "corpus": "tok3_names_3.8MB",
        "enc_MBps": round(len(names) / 1e6 / te, 1),
        "dec_MBps": round(len(names) / 1e6 / td, 1),
        "roundtrip": back == names.replace(b"\n", b"\x00"),
        "ratio": round(len(comp) / len(names), 3),
    })
    return rows


def main():
    t_setup = time.time()
    from htscodecs_tpu._device import configure_cache, gpu_device
    configure_cache()
    try:
        device = gpu_device()
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}), file=sys.stderr)
        return 1

    uniq = synth_quality(G, N)
    corpora = [
        ("synth4", np.tile(uniq, (B // G, 1))),
        ("distinct", synth_quality(B, N, seed=7)),
    ]
    if DAT.exists():
        corpora.append(("q8", tile_file(DAT / "q8", B, N)))
        corpora.append(("q40dir", tile_file(DAT / "q40+dir", B, N)))
    # near-incompressible regime (ratio ~0.78, A=64): lands between
    # the CAT threshold and the easy corpora
    _rng_u = np.random.default_rng(13)
    corpora.append(("uni64", (_rng_u.integers(0, 64, (B // 2, N))
                              + 33).astype(np.uint8)))
    # small-batch regime: the variant winners are reused from the big
    # corpora's tune cache
    corpora.append(("synth4_B512", np.tile(uniq, (min(512, B) // G, 1))))

    # host-codec rows FIRST: they are single-core wall-time
    # measurements and read slower when they share the box with the
    # accumulated device-run state
    try:
        for r in bench_fqz_tok3():
            print(json.dumps(r), file=sys.stderr, flush=True)
    except Exception as e:          # secondary rows must not kill bench
        print(json.dumps({"corpus": "fqz_tok3", "error": str(e)[:200]}),
              file=sys.stderr, flush=True)

    rows = []
    for name, blocks in corpora:
        r = bench_corpus(name, blocks, check_exact=True)
        if r is None:
            r = {"corpus": name, "error": "device path declined"}
        print(json.dumps(r), file=sys.stderr, flush=True)
        rows.append(r)
        import gc
        gc.collect()

    head = rows[0]
    ok = (all(r.get("mismatches", 1) == 0 and r.get("byte_exact", False)
              for r in rows if "error" not in r)
          and not any("error" in r for r in rows))
    print(json.dumps({"setup_s": round(time.time() - t_setup, 1)}),
          file=sys.stderr)
    if not ok:
        print(json.dumps({"error": "a corpus failed its checks"}),
              file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "rans4x16_o1_enc_dec_aggregate",
        "value": head.get("agg_MBps", 0.0),
        "unit": "MB/s",
        "vs_baseline": round(head.get("agg_MBps", 0.0) / BASELINE_AGG_MBPS, 3),
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
