"""Zstandard decoding (RFC 8878) in Python, for TIFF's ZSTD
compression (50000) in utils/tiff_decode.

libtiff hands a strip to libzstd's streaming decoder and stops at the end
of the first frame (or when the strip's bytes are decoded), so `decompress`
decodes one frame: its header (a dictionary ID other than 0 is an error,
as libzstd has no dictionary; a window past 2**27 + 1 fails; no block
may hold or decode to more than the window or 128 KiB), raw blocks
streamed as far as the data goes, RLE and compressed blocks, and the
content checksum (XXH64's low 32 bits) where the frame has one, is
decoded whole and the checksum's bytes are there (libzstd waits for them
else). A compressed block is its literals (raw, RLE, Huffman-coded in one
or four streams, or with the previous block's Huffman table) and its
sequences (literal lengths, match lengths and offsets, each coded with
the predefined FSE table, one symbol, the block's own table or the
previous one; repeat offsets starting at 1, 4, 8), each bit stream read
backwards from its end marker. One Huffman stream, and four where one is
under 8 bytes, must end exactly where its symbols end (libzstd's checked
loops). Four streams of 8 bytes or more go through libzstd 1.5.7's fast
loop (HUF_decompress4X1/X2_usingDTable_internal_fast), which PIL's
libzstd takes on x86-64 with BMI2 (its assembly loop) and on any other
64-bit little-endian host: a stream is read on past its start into the
bytes before it, nothing checks where it ends, and the loop fails only
where it leaves a stream's read pointer more than 8 bytes below the
stream's start (`_fast_literals`); one or two symbols a lookup as
HUF_selectDecoder chooses. An x86-64 CPU without BMI2 (before 2013)
would take the checked loops, which this does not model. Corrupt data
raises DecodeError; nothing returns a partial strip.
"""

from __future__ import annotations

from .image_decode import DecodeError

_MAGIC = 0xFD2FB528
_LL_BASE = (list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                                2048, 4096, 8192, 16384, 32768, 65536])
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = (list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                   1027, 2051, 4099, 8195, 16387, 32771, 65539])
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# the predefined distributions (accuracy log 6, 6, 5)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
                1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
_MAX_LOG = {"ll": 9, "ml": 9, "of": 8}
_MAX_SYMBOL = {"ll": 35, "ml": 52, "of": 31}
_BLOCK_MAX = 128 << 10


class _Forward:
    """Bits read LSB first from `data` at `pos` (zeros past the end)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.base, self.bit = data, pos, 0

    def read(self, n: int) -> int:
        start, end = self.base + self.bit // 8, self.base + (self.bit + n + 7) // 8
        chunk = int.from_bytes(self.data[start:end], "little")
        self.bit += n
        return (chunk >> ((self.bit - n) % 8)) & ((1 << n) - 1)

    def end(self) -> int:
        return self.base + (self.bit + 7) // 8


class _Backward:
    """A bit stream read from its end: the last byte's highest set bit
    marks the start; bits come out most significant first, zeros once the
    data is spent (`overflow` then says so)."""

    def __init__(self, data: bytes):
        if not data or not data[-1]:
            raise DecodeError("ZSTD: a bit stream without its end marker")
        self.data = data
        self.left = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def _bits(self, hi: int, n: int) -> int:
        """The n bits below bit `hi` of the stream (as one little-endian
        number), zeros below bit 0."""
        lo = hi - n
        if hi <= 0:
            return 0
        start = max(lo, 0) >> 3
        chunk = int.from_bytes(self.data[start:(hi + 7) >> 3], "little")
        value = chunk >> (lo - 8 * start) if lo >= 0 else chunk << -lo
        return value & ((1 << n) - 1)

    def read(self, n: int) -> int:
        value = self._bits(self.left, n)
        self.left -= n
        return value

    def peek(self, n: int) -> int:
        return self._bits(self.left, n)

    @property
    def overflow(self) -> bool:
        return self.left < 0


def _read_ncount(data: bytes, pos: int, max_symbol: int, max_log: int):
    """FSE_readNCount: (normalised counts, accuracy log, position after)."""
    r = _Forward(data, pos)
    log = r.read(4) + 5
    if log > max_log:
        raise DecodeError("ZSTD: FSE accuracy log too large")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts, previous0 = [], False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            n0 = len(counts)
            while True:
                rep = r.read(2)
                n0 += rep
                if rep != 3:
                    break
            if n0 > max_symbol:
                raise DecodeError("ZSTD: FSE symbol past the maximum")
            counts += [0] * (n0 - len(counts))
        peek_start, peek_bit = r.base, r.bit
        value = r.read(nbits)
        small = value & (threshold - 1)
        top = (2 * threshold - 1) - remaining
        if small < top:
            count = small
            r.base, r.bit = peek_start, peek_bit + nbits - 1
        else:
            count = value & (2 * threshold - 1)
            if count >= threshold:
                count -= top
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise DecodeError("ZSTD: corrupt FSE table description")
    return counts, log, r.end()


def _fse_table(counts, log: int):
    """FSE_buildDTable: per state (symbol, bits, base)."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step, pos = (size >> 1) + (size >> 3) + 3, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos:
        raise DecodeError("ZSTD: corrupt FSE table")
    table = []
    for u in range(size):
        s = symbol[u]
        n = nxt[s]
        nxt[s] += 1
        bits = log - (n.bit_length() - 1)
        table.append((s, bits, (n << bits) - size))
    return table, log


def _huffman_weights(data: bytes, pos: int):
    """The Huffman tree description: (weights, position after)."""
    if pos >= len(data):
        raise DecodeError("ZSTD: truncated Huffman tree description")
    head = data[pos]
    if head >= 128:
        n = head - 127
        raw = data[pos + 1:pos + 1 + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise DecodeError("ZSTD: truncated Huffman weights")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], pos + 1 + (n + 1) // 2
    end = pos + 1 + head
    if end > len(data):
        raise DecodeError("ZSTD: truncated Huffman weights")
    counts, log, start = _read_ncount(data[:end], pos + 1, 255, 6)
    table, _ = _fse_table(counts, log)
    r = _Backward(data[start:end])
    states = [r.read(log), r.read(log)]
    weights, k = [], 0
    while True:  # the two states in turn until the stream runs out
        sym, bits, base = table[states[k]]
        weights.append(sym)
        states[k] = base + r.read(bits)
        if r.overflow:
            weights.append(table[states[1 - k]][0])
            break
        if len(weights) > 255:
            raise DecodeError("ZSTD: too many Huffman weights")
        k = 1 - k
    return weights, end


def _huffman_table(weights):
    """(max bits, table of 2**max bits (symbol, bits)) from the weights,
    the last symbol's weight implied."""
    total = sum(1 << (w - 1) for w in weights if w)
    if not total or len(weights) > 255:
        raise DecodeError("ZSTD: corrupt Huffman weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise DecodeError("ZSTD: corrupt Huffman weights")
    weights = list(weights) + [rest.bit_length()]
    table = []
    for w in range(1, max_bits + 1):
        for s, sw in enumerate(weights):
            if sw == w:
                table += [(s, max_bits + 1 - w)] * (1 << (w - 1))
    return max_bits, table


def _huffman_stream(data: bytes, count: int, huff) -> bytes:
    max_bits, table = huff[:2]
    r = _Backward(data)
    out = bytearray()
    for _ in range(count):
        s, bits = table[r.peek(max_bits)]
        r.read(bits)
        out.append(s)
    if r.left != 0:
        raise DecodeError("ZSTD: corrupt Huffman stream")
    return bytes(out)


class _State:
    """A frame's state across blocks: the last Huffman and FSE tables and
    the repeat offsets."""

    def __init__(self):
        self.huff = None
        self.fse = {"ll": None, "ml": None, "of": None}
        self.rep = [1, 4, 8]
        self.block_max = _BLOCK_MAX


def _literals(data: bytes, pos: int, end: int, st: _State):
    kind, fmt = data[pos] & 3, (data[pos] >> 2) & 3
    if kind in (0, 1):
        head = {0: 1, 2: 1, 1: 2, 3: 3}[fmt]
        h = int.from_bytes(data[pos:pos + head], "little")
        size = h >> 3 if fmt in (0, 2) else h >> 4
        pos += head
        if kind == 0:
            if pos + size > end:
                raise DecodeError("ZSTD: truncated raw literals")
            return data[pos:pos + size], pos + size
        if pos >= end:
            raise DecodeError("ZSTD: truncated RLE literals")
        return bytes([data[pos]]) * size, pos + 1
    head = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    bits = {0: 10, 1: 10, 2: 14, 3: 18}[fmt]
    h = int.from_bytes(data[pos:pos + head], "little")
    size, csize = (h >> 4) & ((1 << bits) - 1), (h >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if fmt == 0 else 4
    pos += head
    stop = pos + csize
    if stop > end or size > st.block_max:
        raise DecodeError("ZSTD: corrupt literals section")
    if kind == 2:
        weights, pos = _huffman_weights(data[:stop], pos)
        st.huff = _huffman_table(weights) + (streams == 4 and _double_symbols(size, csize),)
    elif st.huff is None:
        raise DecodeError("ZSTD: treeless literals without a previous Huffman table")
    if streams == 1:
        return _huffman_stream(data[pos:stop], size, st.huff), stop
    if stop - pos < 10 or size < 6:
        raise DecodeError("ZSTD: corrupt four-stream literals")
    sizes = [int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3)]
    sizes.append(stop - pos - 6 - sum(sizes))
    each = (size + 3) // 4
    counts = [each, each, each, size - 3 * each]
    if sizes[3] < 0:
        raise DecodeError("ZSTD: corrupt jump table")
    if min(sizes) >= 8 and counts[3] > 0:
        return _fast_literals(data[pos:stop], sizes, counts, st.huff), stop
    out, pos = b"", pos + 6
    for n, c in zip(sizes, counts):
        out += _huffman_stream(data[pos:pos + n], c, st.huff)
        pos += n
    return out, stop


# HUF_selectDecoder's timings (huf_decompress.c, algoTime): by the
# compressed share Q, (table, a 256 bytes) for one and two symbols a lookup
_ALGO_TIME = ((0, 0, 1, 1), (0, 0, 1, 1), (150, 216, 381, 119), (170, 205, 514, 112),
              (177, 199, 539, 110), (197, 194, 644, 107), (221, 192, 735, 107),
              (256, 189, 881, 106), (359, 188, 1167, 109), (582, 187, 1570, 114),
              (688, 187, 1712, 122), (825, 186, 1965, 136), (976, 185, 2131, 150),
              (1180, 186, 2070, 175), (1377, 185, 1731, 202), (1412, 185, 1695, 202))
_FAST_LOG = 11  # HUF_DECODER_FAST_TABLELOG: every literals table is read 11 bits a lookup


def _double_symbols(size: int, csize: int) -> bool:
    """HUF_selectDecoder: whether four-stream literals with a new table
    are decoded two symbols a lookup (HUF_decompress4X2), which a later
    block reusing the table keeps."""
    q = 15 if csize >= size else csize * 16 // size
    t0, d0, t1, d1 = _ALGO_TIME[q]
    single, double = t0 + d0 * (size >> 8), t1 + d1 * (size >> 8)
    return double + (double >> 5) < single


def _fast_literals(sec: bytes, sizes, counts, huff) -> bytes:
    """Four Huffman streams as libzstd's fast decoder reads them
    (HUF_decompress4X1/X2_usingDTable_internal_fast, the loop libzstd
    takes where each stream has 8 bytes or more, on an x86-64 CPU with
    BMI2 (its assembly loop) and on other 64-bit little-endian hosts).
    `sec` is the streams with their jump table. A stream is read
    backwards from its end marker (a last byte of 0 holds no marker: its
    bits are read) on past its start into the bytes before it, down to the
    jump table, and nothing checks where it ends; below the jump table's
    first byte the bit container of its first eight bytes is read round
    and round (BIT_lookBitsFast's shift modulo 64). The fast loop, 5
    lookups a stream an iteration while each stream's input and output
    allow, must leave each stream's read pointer no more than 8 bytes
    below its start (HUF_initRemainingDStream); the rest of each stream
    is decoded on from there."""
    max_bits, table, double = huff
    shortest = min(bits for _, bits in table)
    ends, at = [], 6
    for n in sizes:
        at += n
        ends.append(at)
    total = 8 * len(sec)
    word = int.from_bytes(sec[:8], "little")

    def window(p: int) -> int:  # the 11 bits below bit p of sec (as the lookups see them)
        if p >= _FAST_LOG:
            lo = p - _FAST_LOG
            return int.from_bytes(sec[lo >> 3:(p + 7) >> 3], "little") >> (lo & 7) & 0x7FF
        if p <= 0:
            p = (p - 1) % 64 + 1
        return (word << (64 - p) & 0xFFFFFFFFFFFFFFFF) >> 53

    out = bytearray()
    looks = []  # each stream's lookups: (bits, symbols)
    for end, count in zip(ends, counts):
        last = sec[end - 1]
        p = 8 * end - (8 - last.bit_length() + 1 if last else 0)
        mine, n = [], 0
        while n < count:
            w = window(p) if p <= total else 0
            s1, b1 = table[w >> (_FAST_LOG - max_bits)]
            if double and count - n >= 2 and _FAST_LOG - b1 >= shortest:
                s2, b2 = table[(w << b1 & 0x7FF) >> (_FAST_LOG - max_bits)]
                if b2 <= _FAST_LOG - b1:
                    out += bytes((s1, s2))
                    mine.append((b1 + b2, 2))
                    p, n = p - b1 - b2, n + 2
                    continue
            out.append(s1)
            mine.append((b1, 1))
            p, n = p - b1, n + 1
        looks.append(mine)
    # the fast loop: where each stream's read pointer stands when it ends
    ip = [end - 8 for end in ends]
    used = [8 - sec[end - 1].bit_length() + 1 if sec[end - 1] else 0 for end in ends]
    k, op = [0] * 4, [sum(counts[:i]) for i in range(4)]
    stops = [sum(counts[:i + 1]) for i in range(4)]
    while True:
        iters = ip[0] // 7
        if double:
            iters = min([iters] + [(stops[i] - op[i]) // 10 for i in range(4)])
        else:
            iters = min(iters, (stops[3] - op[3]) // 5)
        limit = op[3] + 5 * iters
        if op[3] == limit or any(ip[i] < ip[i - 1] for i in (1, 2, 3)):
            break
        while op[3] < limit:
            for i in range(4):
                for bits, n in looks[i][k[i]:k[i] + 5]:
                    used[i] += bits
                    op[i] += n
                k[i] += 5
                ip[i] -= used[i] >> 3
                used[i] &= 7
    for i in range(4):
        if ip[i] < ends[i] - sizes[i] - 8:
            raise DecodeError("ZSTD: corrupt Huffman stream (read past its start)")
    return bytes(out)


def _seq_table(data: bytes, pos: int, end: int, mode: int, kind: str, st: _State):
    if mode == 0:
        table = _fse_table(*{"ll": _LL_DEFAULT, "ml": _ML_DEFAULT, "of": _OF_DEFAULT}[kind])
    elif mode == 1:
        if pos >= end or data[pos] > _MAX_SYMBOL[kind]:
            raise DecodeError("ZSTD: corrupt RLE sequence table")
        table, pos = ([(data[pos], 0, 0)], 0), pos + 1
    elif mode == 2:
        counts, log, pos = _read_ncount(data[:end], pos, _MAX_SYMBOL[kind], _MAX_LOG[kind])
        table = _fse_table(counts, log)
    else:
        table = st.fse[kind]
        if table is None:
            raise DecodeError("ZSTD: a repeated sequence table without a previous one")
    st.fse[kind] = table
    return table, pos


def _sequences(data: bytes, pos: int, end: int, st: _State, lits: bytes, out: bytearray,
               frame_start: int) -> None:
    if pos >= end:
        raise DecodeError("ZSTD: truncated sequences section")
    b0 = data[pos]
    if b0 == 0:
        n, pos = 0, pos + 1
    elif b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        n, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if n == 0:
        if pos != end:
            raise DecodeError("ZSTD: data after an empty sequences section")
        out += lits
        return
    modes = data[pos]
    if modes & 3:
        raise DecodeError("ZSTD: reserved sequence compression bits set")
    pos += 1
    ll, pos = _seq_table(data, pos, end, modes >> 6, "ll", st)
    of, pos = _seq_table(data, pos, end, (modes >> 4) & 3, "of", st)
    ml, pos = _seq_table(data, pos, end, (modes >> 2) & 3, "ml", st)
    r = _Backward(data[pos:end])
    (llt, lll), (oft, ofl), (mlt, mll) = ll, of, ml
    sl, so, sm = r.read(lll), r.read(ofl), r.read(mll)
    rep, lit = st.rep, 0
    for k in range(n):
        code = oft[so][0]
        if code > 31:
            raise DecodeError("ZSTD: offset code past 31")
        value = (1 << code) + r.read(code)
        mcode, lcode = mlt[sm][0], llt[sl][0]
        mlen = _ML_BASE[mcode] + r.read(_ML_BITS[mcode])
        llen = _LL_BASE[lcode] + r.read(_LL_BITS[lcode])
        if value > 3:
            offset = value - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            idx = value - 1 + (llen == 0)
            if idx:
                offset = rep[idx] if idx < 3 else rep[0] - 1
                if idx > 1:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], offset
            else:
                offset = rep[0]
        if k != n - 1:
            for which in ("l", "m", "o"):
                table, s = {"l": (llt, sl), "m": (mlt, sm), "o": (oft, so)}[which]
                _, bits, base = table[s]
                new = base + r.read(bits)
                if which == "l":
                    sl = new
                elif which == "m":
                    sm = new
                else:
                    so = new
        if lit + llen > len(lits):
            raise DecodeError("ZSTD: a sequence past the literals")
        out += lits[lit:lit + llen]
        lit += llen
        start = len(out) - offset
        if offset <= 0 or start < frame_start:
            raise DecodeError("ZSTD: a match before the frame's start")
        if offset >= mlen:
            out += out[start:start + mlen]
        else:
            for i in range(mlen):
                out.append(out[start + i])
    if r.left != 0:
        raise DecodeError("ZSTD: corrupt sequences bit stream")
    out += lits[lit:]


def _xxh64(data: bytes) -> int:
    """XXH64 with seed 0."""
    p1, p2, p3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
    p4, p5, m = 9650029242287828579, 2870177450012600261, (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def rnd(acc, lane):
        return (rotl((acc + lane * p2) & m, 31) * p1) & m

    n, i = len(data), 0
    if n >= 32:
        v = [(p1 + p2) & m, p2, 0, (-p1) & m]
        while i + 32 <= n:
            for j in range(4):
                v[j] = rnd(v[j], int.from_bytes(data[i + 8 * j:i + 8 * j + 8], "little"))
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & m
        for x in v:
            h = ((h ^ rnd(0, x)) * p1 + p4) & m
    else:
        h = p5
    h = (h + n) & m
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27) * p1 + p4) & m
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * p1 & m), 23) * p2 + p3) & m
        i += 4
    while i < n:
        h = (rotl(h ^ (data[i] * p5 & m), 11) * p1) & m
        i += 1
    h = ((h ^ (h >> 33)) * p2) & m
    h = ((h ^ (h >> 29)) * p3) & m
    return h ^ (h >> 32)


def decompress(data: bytes, size: int) -> bytes:
    """The first `size` bytes of the first Zstandard frame in `data` (after
    any skippable frames), as libtiff's ZSTD codec reads a strip."""
    pos = 0
    while True:
        if pos + 4 > len(data):
            raise DecodeError("ZSTD: no frame")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # skippable
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            continue
        if magic != _MAGIC:
            raise DecodeError("ZSTD: unknown frame descriptor")
        break
    pos += 4
    if pos >= len(data):
        raise DecodeError("ZSTD: truncated frame header")
    fhd = data[pos]
    pos += 1
    if fhd & 8:
        raise DecodeError("ZSTD: reserved frame header bit set")
    single, dict_size = fhd >> 5 & 1, (0, 1, 2, 4)[fhd & 3]
    fcs_size = (1 if single else 0, 2, 4, 8)[fhd >> 6]
    if pos + (0 if single else 1) + dict_size + fcs_size > len(data):
        raise DecodeError("ZSTD: truncated frame header")
    if not single:  # the window: libzstd's largest by default is 2**27 (+ 1)
        log, mantissa = 10 + (data[pos] >> 3), data[pos] & 7
        window = (1 << log) + ((1 << log) >> 3) * mantissa
        pos += 1
    dict_id = int.from_bytes(data[pos:pos + dict_size], "little")
    pos += dict_size
    fcs = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    pos += fcs_size
    if single:
        window = fcs
    if window > (1 << 27) + 1:
        raise DecodeError("ZSTD: frame window too large")
    if dict_id:
        raise DecodeError("ZSTD: a frame that needs a dictionary")
    st, out = _State(), bytearray()
    st.block_max = min(window, _BLOCK_MAX)  # blockSizeMax: no block holds more
    while len(out) < size:
        if pos + 3 > len(data):
            raise DecodeError("ZSTD: truncated block header")
        head = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, bsize = head & 1, (head >> 1) & 3, head >> 3
        if bsize > st.block_max and kind != 3:
            raise DecodeError("ZSTD: a block larger than the frame's window allows")
        if kind == 0:  # streamed: as much as the data holds
            out += data[pos:pos + bsize]
            pos += bsize
            if pos > len(data):
                break
        elif kind == 1:
            if pos >= len(data):
                raise DecodeError("ZSTD: truncated RLE block")
            out += bytes([data[pos]]) * bsize
            pos += 1
        elif kind == 2:
            end = pos + bsize
            if end > len(data):
                raise DecodeError("ZSTD: truncated compressed block")
            lits, at = _literals(data, pos, end, st)
            before = len(out)
            _sequences(data, at, end, st, lits, out, 0)
            if len(out) - before > st.block_max:
                raise DecodeError("ZSTD: a block decodes to more than the frame's window allows")
            pos = end
        else:
            raise DecodeError("ZSTD: reserved block type")
        if last:
            # libzstd checks the checksum when it has it (and waits for it else)
            if fhd & 4 and len(out) <= size and pos + 4 <= len(data):
                if _xxh64(bytes(out)) & 0xFFFFFFFF != int.from_bytes(data[pos:pos + 4], "little"):
                    raise DecodeError("ZSTD: content checksum mismatch")
            break
    if len(out) < size:
        raise DecodeError("TIFF: not enough ZSTD data for a strip")
    return bytes(out[:size])
