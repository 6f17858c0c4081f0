"""The AV1 symbol decoder (AV1 specification section 8.2).

`SymbolDecoder` is init_symbol / read_symbol / read_bool / read_literal
(and NS(n) over literal bits) as the specification writes them, on CDF
rows kept as 32768 minus the specification's values (av1_tables:
[32768 - cdf[0], ..., 0, count]): SymbolValue, SymbolRange and the 15-bit
renormalisation, the bits past a tile's end read as zeros
(SymbolMaxBits), and each read adapting its row unless the frame sets
disable_cdf_update. The default CDF rows are in av1_tables.
"""

from __future__ import annotations


class SymbolDecoder:
    __slots__ = ("data", "pos", "window", "avail", "bitpos", "value", "rng", "adapt")

    def __init__(self, data: bytes, disable_cdf_update: bool):
        self.data = bytes(data)
        self.pos = 0  # the next byte to load into the window
        self.window = 0  # the loaded bits not read yet, `avail` of them
        self.avail = 0
        self.bitpos = 0  # bits read, those past the tile's end included
        self.value = ((1 << 15) - 1) ^ self._bits(15)
        self.rng = 1 << 15
        self.adapt = not disable_cdf_update

    def _bits(self, n: int) -> int:
        """The next n (at most 15) bits; past the tile's end they are zeros."""
        self.bitpos += n
        avail = self.avail
        if avail < n:
            p = self.pos
            self.window = (self.window << 48) | int.from_bytes(
                self.data[p:p + 6].ljust(6, b"\0"), "big")
            self.pos = p + 6
            avail += 48
        avail -= n
        self.avail = avail
        v = self.window >> avail
        self.window &= (1 << avail) - 1
        return v

    def read_symbol(self, cdf: list) -> int:
        n = len(cdf) - 1
        rng8 = self.rng >> 8
        value = self.value
        cur = self.rng
        s = -1
        while True:
            s += 1
            prev = cur
            cur = ((rng8 * (cdf[s] >> 6)) >> 1) + 4 * (n - s - 1)
            if value >= cur:
                break
        rng = prev - cur
        value -= cur
        bits = 16 - rng.bit_length()
        self.rng = rng << bits
        if bits:
            self.value = ((value + 1) << bits) - 1 ^ self._bits(bits)
        else:
            self.value = value
        if self.adapt:
            cnt = cdf[n]
            rate = 3 + (cnt > 15) + (cnt > 31) + (2 if n > 3 else 1)
            for i in range(n - 1):
                if i < s:
                    cdf[i] += (32768 - cdf[i]) >> rate
                else:
                    cdf[i] -= cdf[i] >> rate
            if cnt < 32:
                cdf[n] = cnt + 1
        return s

    def read_bool(self) -> int:
        rng = self.rng
        value = self.value
        cur = ((rng >> 8) << 7) + 4
        if value >= cur:
            s, rng, value = 0, rng - cur, value - cur
        else:
            s, rng = 1, cur
        bits = 16 - rng.bit_length()
        self.rng = rng << bits
        self.value = (((value + 1) << bits) - 1 ^ self._bits(bits)) if bits else value
        return s

    def read_literal(self, n: int) -> int:
        x = 0
        for _ in range(n):
            x = 2 * x + self.read_bool()
        return x

    def read_ns(self, n: int) -> int:
        """NS(n): a value below n in the fewest literal bits (4.10.10)."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.read_literal(w - 1)
        return v if v < m else (v << 1) - m + self.read_literal(1)

    def read_bool_cdf(self, p: int) -> int:
        """A symbol of a two-symbol row [p, 0] made for the one read (the
        partition's split_or_horz and split_or_vert; its adaptation is
        dropped with it)."""
        return self.read_symbol([p, 0, 0])
