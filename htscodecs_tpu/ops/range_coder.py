"""Carry-counting byte-oriented range coder.

Exact re-derivation of the Shelwien-style coder used by the adaptive
codecs (``/root/reference/htscodecs/c_range_coder.h``): 32-bit low /
range / code, TOP = 1<<24, deferred-carry emission through a cache byte
plus a run of 0xFF placeholders.  The first emitted byte is always the
initial (zero) cache; decoders prime with five bytes.

This coder is inherently sequential per stream — the device engine
parallelises across blocks, not within them (see ops/arith_jax.py).
"""

from __future__ import annotations

TOP = 1 << 24
THRES = 0xFF000000
M32 = 0xFFFFFFFF


class RangeEncoder:
    __slots__ = ("low", "range", "ffnum", "cache", "carry", "out")

    def __init__(self) -> None:
        self.low = 0
        self.range = M32
        self.ffnum = 0
        self.carry = 0
        self.cache = 0
        self.out = bytearray()

    def _shift_low(self) -> None:
        if self.low < THRES or self.carry:
            self.out.append((self.cache + self.carry) & 0xFF)
            if self.ffnum:
                b = (self.carry - 1) & 0xFF
                self.out.extend([b] * self.ffnum)
                self.ffnum = 0
            self.cache = self.low >> 24
            self.carry = 0
        else:
            self.ffnum += 1
        self.low = (self.low << 8) & M32

    def encode(self, cum_freq: int, freq: int, tot_freq: int) -> None:
        r = self.range // tot_freq
        self.range = r
        old = self.low
        self.low = (self.low + cum_freq * r) & M32
        if self.low < old:
            self.carry += 1
        self.range = (self.range * freq) & M32
        while self.range < TOP:
            self.range = (self.range << 8) & M32
            self._shift_low()

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    __slots__ = ("code", "range", "buf", "pos", "end")

    def __init__(self, buf, pos: int, end: int) -> None:
        self.range = M32
        self.code = 0
        self.buf = buf
        self.pos = pos
        self.end = end
        if pos + 5 >= end:
            self.pos = end  # prevent decode, as the reference does
            return
        for _ in range(5):
            self.code = ((self.code << 8) | buf[self.pos]) & 0xFFFFFFFFFF
            self.pos += 1
        self.code &= M32

    def get_freq(self, tot_freq: int) -> int:
        if tot_freq and self.range >= tot_freq:
            self.range //= tot_freq
            return self.code // self.range
        return 0

    def decode(self, cum_freq: int, freq: int) -> None:
        self.code = (self.code - cum_freq * self.range) & M32
        self.range = (self.range * freq) & M32
        while self.range < TOP:
            if self.pos >= self.end:
                return
            self.code = ((self.code << 8) | self.buf[self.pos]) & M32
            self.pos += 1
            self.range = (self.range << 8) & M32


MAX_FREQ = (1 << 16) - 17
STEP = 16


class SimpleModel:
    """Adaptive frequency model with approximate-sort bubble step
    (``c_simple_model.h``).  The linear-search order and the one-step
    swap are part of the bitstream contract and are replicated exactly.
    """

    __slots__ = ("nsym", "syms", "freqs", "total")

    def __init__(self, nsym: int, max_sym: int) -> None:
        self.nsym = nsym
        self.syms = list(range(nsym))
        self.freqs = [1] * max_sym + [0] * (nsym - max_sym)
        self.total = max_sym

    def _normalize(self) -> None:
        total = 0
        freqs = self.freqs
        for i in range(self.nsym):
            f = freqs[i]
            if not f:
                break
            f -= f >> 1
            freqs[i] = f
            total += f
        self.total = total

    def encode(self, rc: RangeEncoder, sym: int) -> None:
        syms = self.syms
        freqs = self.freqs
        p = 0
        acc = 0
        while syms[p] != sym:
            acc += freqs[p]
            p += 1
        rc.encode(acc, freqs[p], self.total)
        freqs[p] += STEP
        self.total += STEP
        if self.total > MAX_FREQ:
            self._normalize()
        if p and freqs[p] > freqs[p - 1]:
            syms[p], syms[p - 1] = syms[p - 1], syms[p]
            freqs[p], freqs[p - 1] = freqs[p - 1], freqs[p]

    def decode(self, rc: RangeDecoder) -> int:
        freq = rc.get_freq(self.total)
        if freq > MAX_FREQ:
            return 0  # corrupt stream; reference bails identically
        syms = self.syms
        freqs = self.freqs
        n = self.nsym
        acc = 0
        p = 0
        while True:
            f = freqs[p] if p < n else (0 if p == n else MAX_FREQ)
            if acc + f > freq:
                break
            acc += f
            p += 1
            if p > n + 1:
                return 0
        if p > n:
            return 0  # walked past the terminal sentinel
        sym = syms[p]
        rc.decode(acc, freqs[p])
        freqs[p] += STEP
        self.total += STEP
        if self.total > MAX_FREQ:
            self._normalize()
        if p and freqs[p] > freqs[p - 1]:
            syms[p], syms[p - 1] = syms[p - 1], syms[p]
            freqs[p], freqs[p - 1] = freqs[p - 1], freqs[p]
        return sym
