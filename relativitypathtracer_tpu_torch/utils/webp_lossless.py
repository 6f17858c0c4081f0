"""WebP lossless (VP8L) decoding in numpy and the standard library.

`decode_vp8l` returns the (H, W, 4) uint8 RGBA pixels of a VP8L bitstream
(the payload of a "VP8L" chunk) as libwebp 1.6.0 decodes them (RFC 9649),
and `decode_vp8l_stream` the (H, W) uint32 ARGB pixels of a headerless
stream of a size given elsewhere (an ALPH chunk's, whose green channel is
the alpha). Lossless decoding is exact by its specification; what follows
libwebp where the specification leaves room: predictor modes 14 and 15
predict black, a palette index past the colour table is transparent
black, a prefix code with one symbol is zero bits long, any other code
must be complete (libwebp's BuildHuffmanTable), and reading past the end
of the data is an error (VP8LIsEndOfStream: past max(8 * length, 64)
bits, the bits there read as zeros).

The entropy decode is the one sequential part, a Python loop over symbols
(a peek of the code's longest length into a lookup table a symbol, from
little-endian 64-bit words at every byte). The predictor transform runs
along wavefronts x + 2y = t (each pixel's left, top-left, top and
top-right neighbours lie on earlier ones), every pixel of a wavefront
under one mode at once; the other transforms are vectorised over the
image.
"""

from __future__ import annotations

import numpy as np

from .image_decode import DecodeError, _check_size

_ALPHABETS = (256 + 24, 256, 256, 256, 40)  # green (+ cache), red, blue, alpha, distance
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_MAX_LENGTH = 15
_CACHE_MUL = 0x1E35A7BD


def _code_to_plane() -> list:
    """The 120 (dx, dy) neighbours a distance code 1-120 names: every dy in
    0-7 and dx in -7..8 (dx > 0 where dy is 0), nearest first, ties by
    larger dy, then positive dx (RFC 9649 section 4.2.2)."""
    pts = [(x, y) for y in range(8) for x in range(-7, 9) if y or x > 0]
    return sorted(pts, key=lambda p: (p[0] ** 2 + p[1] ** 2, -p[1], p[0] < 0))


_PLANE = _code_to_plane()


class _Bits:
    """LSB-first bit reader: `words[i]` is the little-endian 64-bit word at
    byte i (zeros past the data), `pos` the next bit."""

    def __init__(self, data: bytes):
        d = np.frombuffer(bytes(data) + bytes(16), np.uint8).astype(np.uint64)
        n = d.size - 8
        w = np.zeros(n, np.uint64)
        for i in range(7, -1, -1):
            w = (w << np.uint64(8)) | d[i:i + n]
        self.words = w.tolist()
        self.pos = 0
        self.limit = max(8 * len(data), 64)

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.words[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        if self.pos > self.limit:
            raise DecodeError("truncated or corrupt WebP lossless data: it reads past its end")


def _table(lengths: np.ndarray) -> tuple:
    """The decoding table of a canonical prefix code from its code lengths:
    (entries, mask); entry (symbol << 4) | length at each `mask`-bit peek
    (bits in reading order)."""
    syms = np.flatnonzero(lengths)
    if syms.size == 0:
        raise DecodeError("corrupt WebP lossless data: a prefix code with no symbol")
    if syms.size == 1:
        return [int(syms[0]) << 4], 0
    lens = lengths[syms].astype(np.int64)
    if int((1 << (_MAX_LENGTH - lens)).sum()) != 1 << _MAX_LENGTH:
        raise DecodeError("corrupt WebP lossless data: an incomplete or oversubscribed prefix code")
    order = np.lexsort((syms, lens))
    syms, lens = syms[order], lens[order]
    counts = np.bincount(lens, minlength=_MAX_LENGTH + 1)
    next_code, code = np.zeros(_MAX_LENGTH + 1, np.int64), 0
    for n in range(1, _MAX_LENGTH + 1):
        code = (code + int(counts[n - 1])) << 1
        next_code[n] = code
    rank = np.arange(syms.size) - np.concatenate([[0], np.cumsum(counts)])[lens]
    codes = next_code[lens] + rank
    rev = np.zeros_like(codes)  # the code's bits in reading order, first bit lowest
    for b in range(_MAX_LENGTH):
        rev |= np.where(b < lens, ((codes >> np.maximum(lens - 1 - b, 0)) & 1) << b, 0)
    top = int(lens.max())
    table = np.empty(1 << top, np.int64)
    for n in np.unique(lens):
        sel = lens == n
        idx = rev[sel][:, None] + (np.arange(1 << (top - n)) << n)[None, :]
        table[idx] = ((syms[sel] << 4) | n)[:, None]
    return table.tolist(), (1 << top) - 1


def _read_code(br: _Bits, alphabet: int) -> tuple:
    """One prefix code (RFC 9649 section 3.7.2.1): a simple code of one or
    two symbols, or code lengths coded with the code-length code."""
    lengths = np.zeros(max(alphabet, 256), np.int64)
    if br.read(1):
        count = br.read(1) + 1
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if count == 2:
            lengths[br.read(8)] = 1
        br.check()
        return _table(lengths[:alphabet])
    ll = np.zeros(19, np.int64)
    for i in range(br.read(4) + 4):
        ll[_CODE_LENGTH_ORDER[i]] = br.read(3)
    tab, mask = _table(ll)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise DecodeError("corrupt WebP lossless data: max_symbol past the alphabet")
    else:
        max_symbol = alphabet
    out, prev, sym = lengths[:alphabet], 8, 0
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        e = tab[(br.words[br.pos >> 3] >> (br.pos & 7)) & mask]
        br.pos += e & 15
        code = e >> 4
        if code < 16:
            out[sym] = code
            sym += 1
            if code:
                prev = code
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[code - 16]
            repeat = br.read(extra) + offset
            if sym + repeat > alphabet:
                raise DecodeError("corrupt WebP lossless data: code lengths past the alphabet")
            out[sym:sym + repeat] = prev if code == 16 else 0
            sym += repeat
    br.check()
    return _table(out)


def _prefix_value(br: _Bits, sym: int) -> int:
    """A length or distance from its prefix symbol and extra bits."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _decode_image(br: _Bits, width: int, height: int, level0: bool) -> np.ndarray:
    """An entropy-coded image (the colour cache, the meta prefix codes
    where `level0`, the prefix-code groups, the pixels): (height * width,)
    uint32 ARGB."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise DecodeError(f"corrupt WebP lossless data: a colour cache of {cache_bits} bits")
    groups_of, hbits, hx = None, 0, 0
    ngroups = 1
    if level0 and br.read(1):
        hbits = br.read(3) + 2
        hx = -(-width // (1 << hbits))
        hy = -(-height // (1 << hbits))
        meta = _decode_image(br, hx, hy, False)
        groups_of = ((meta >> 8) & 0xFFFF).astype(np.int64)
        ngroups = int(groups_of.max()) + 1
        groups_of = groups_of.tolist()
    groups = []
    for _ in range(ngroups):
        codes = []
        for j, size in enumerate(_ALPHABETS):
            codes.append(_read_code(br, size + ((1 << cache_bits) if j == 0 and cache_bits else 0)))
        groups.append(tuple(codes))
    out = _decode_pixels(br, width, height, groups, groups_of, hbits, hx, cache_bits)
    br.check()
    return out


def _decode_pixels(br, width, height, groups, groups_of, hbits, hx, cache_bits) -> np.ndarray:
    """The pixel loop (libwebp DecodeImageData): literals, LZ77 copies
    (length and distance prefix codes, the 120-entry distance map) and
    colour-cache hits; each pixel's prefix-code group is its entropy-image
    block's."""
    words = br.words
    p = br.pos
    n = width * height
    out = [0] * n
    pos = col = row = 0
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0
    cache_limit = 280 + (1 << cache_bits if cache_bits else 0)
    (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[0]
    meta = groups_of is not None
    while pos < n:
        if meta:
            (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[
                groups_of[(row >> hbits) * hx + (col >> hbits)]]
        e = gt[(words[p >> 3] >> (p & 7)) & gm]
        p += e & 15
        code = e >> 4
        if code < 256:
            e = rt[(words[p >> 3] >> (p & 7)) & rm]
            p += e & 15
            red = e >> 4
            e = bt[(words[p >> 3] >> (p & 7)) & bm]
            p += e & 15
            blue = e >> 4
            e = at[(words[p >> 3] >> (p & 7)) & am]
            p += e & 15
            out[pos] = ((e >> 4) << 24) | (red << 16) | (code << 8) | blue
            pos += 1
            col += 1
            if col == width:
                col = 0
                row += 1
        elif code < 280:
            br.pos = p
            length = _prefix_value(br, code - 256)
            p = br.pos
            e = dt[(words[p >> 3] >> (p & 7)) & dm]
            br.pos = p + (e & 15)
            dcode = _prefix_value(br, e >> 4)
            p = br.pos
            if dcode > 120:
                dist = dcode - 120
            else:
                dx, dy = _PLANE[dcode - 1]
                dist = max(dy * width + dx, 1)
            if dist > pos or length > n - pos:
                raise DecodeError("corrupt WebP lossless data: a copy outside the image")
            src = pos - dist
            if dist >= length:
                out[pos:pos + length] = out[src:src + length]
            else:
                run = out[src:pos]
                out[pos:pos + length] = (run * (length // dist + 1))[:length]
            pos += length
            col += length
            while col >= width:
                col -= width
                row += 1
        elif code < cache_limit:
            for px in out[cached:pos]:
                cache[((px * _CACHE_MUL) & 0xFFFFFFFF) >> shift] = px
            cached = pos
            out[pos] = cache[code - 280]
            pos += 1
            col += 1
            if col == width:
                col = 0
                row += 1
        else:
            raise DecodeError("corrupt WebP lossless data: a green symbol past the alphabet")
    br.pos = p
    br.check()
    return np.array(out, np.uint32)


def _channels(argb: np.ndarray) -> np.ndarray:
    """(n,) uint32 ARGB -> (n, 4) int32 A, R, G, B."""
    return (argb[:, None] >> np.array([24, 16, 8, 0], np.uint32) & 255).astype(np.int32)


def _pack(ch: np.ndarray) -> np.ndarray:
    ch = ch.astype(np.uint32)
    return (ch[:, 0] << 24) | (ch[:, 1] << 16) | (ch[:, 2] << 8) | ch[:, 3]


def _avg(a, b):
    return (a + b) >> 1


def _predict(mode: int, L, T, TL, TR):
    """Predictor `mode` (RFC 9649 section 4.1) on (n, 4) channel arrays."""
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:  # select: T where L is nearer the gradient L + T - TL
        pick_t = np.abs(L - TL).sum(1) <= np.abs(T - TL).sum(1)
        return np.where(pick_t[:, None], T, L)
    if mode == 12:
        return np.clip(L + T - TL, 0, 255)
    a = _avg(L, T)  # 13; libwebp's (a - TL) / 2 truncates towards zero
    d = a - TL
    return np.clip(a + ((d + (d < 0)) >> 1), 0, 255)


_NEEDS = {1: "L", 2: "T", 3: "R", 4: "D", 5: "LRT", 6: "LD", 7: "LT", 8: "DT", 9: "TR",
          10: "LDTR", 11: "LTD", 12: "LTD", 13: "LTD"}


def _unpredict(res: np.ndarray, width: int, height: int, bits: int, modes: np.ndarray):
    """Undo the predictor transform: `res` (n, 4) residual channels, `modes`
    the transform image (ARGB, its green's low nibble the mode of each
    2**bits square). Row 0 predicts from the left (its first pixel from
    black), column 0 from the top."""
    n = width * height
    y, x = np.divmod(np.arange(n), width)
    bx = -(-width // (1 << bits))
    mode = ((modes[(y >> bits) * bx + (x >> bits)] >> 8) & 15).astype(np.int64)
    mode[mode >= 14] = 0
    mode[x == 0] = 2
    mode[y == 0] = 1
    mode[0] = 0
    key = (x + 2 * y) * 16 + mode
    order = np.argsort(key, kind="stable")
    key = key[order]
    cuts = np.flatnonzero(np.diff(key)) + 1
    out = np.empty_like(res)
    starts = np.concatenate([[0], cuts]).tolist()
    ends = np.concatenate([cuts, [n]]).tolist()
    black = np.array([255, 0, 0, 0], np.int32)
    for s, e in zip(starts, ends):
        idx = order[s:e]
        m = int(key[s]) & 15
        if m == 0:
            out[idx] = (res[idx] + black) & 255
            continue
        need = _NEEDS[m]
        L = out[idx - 1] if "L" in need else None
        T = out[idx - width] if "T" in need else None
        TL = out[idx - width - 1] if "D" in need else None
        TR = out[idx - width + 1] if "R" in need else None  # column W-1: the row's first pixel
        out[idx] = (res[idx] + _predict(m, L, T, TL, TR)) & 255
    return out


def _int8(v):
    return ((v + 128) & 255) - 128


def _uncross(ch: np.ndarray, width: int, height: int, bits: int, image: np.ndarray):
    """Undo the colour transform: signed 3.5 fixed-point multipliers
    green-to-red, green-to-blue and red-to-blue of each 2**bits square."""
    y, x = np.divmod(np.arange(width * height), width)
    bx = -(-width // (1 << bits))
    m = image[(y >> bits) * bx + (x >> bits)].astype(np.int64)
    g2r, g2b, r2b = _int8(m & 255), _int8((m >> 8) & 255), _int8((m >> 16) & 255)
    green = _int8(ch[:, 2].astype(np.int64))
    red = (ch[:, 1] + ((g2r * green) >> 5)) & 255
    blue = ch[:, 3] + ((g2b * green) >> 5)
    blue = (blue + ((r2b * _int8(red)) >> 5)) & 255
    out = ch.copy()
    out[:, 1], out[:, 3] = red, blue
    return out


def _unindex(argb: np.ndarray, width: int, height: int, bits: int, palette: np.ndarray):
    """Undo colour indexing: each packed pixel's green holds 2**bits
    indices of 8 >> bits bits, lowest first; the palette is padded with
    transparent black to 2**(8 >> bits) entries (256 unbundled)."""
    size = 1 << (8 >> bits)
    pal = np.zeros(max(size, palette.size), np.uint32)
    pal[:palette.size] = palette
    packed_w = -(-width // (1 << bits))
    green = ((argb.reshape(height, packed_w) >> 8) & 255).astype(np.int64)
    if bits:
        per = 8 >> bits
        sub = np.arange(width)
        idx = (green[:, sub >> bits] >> ((sub & ((1 << bits) - 1)) * per)) & ((1 << per) - 1)
    else:
        idx = green
    return pal[idx].ravel()


def _read_stream(br: _Bits, width: int, height: int) -> tuple:
    """The transforms and the entropy-coded image: (the transforms in
    reading order as (kind, width, bits, data), the (n,) uint32 ARGB
    pixels). Colour indexing narrows what follows it to the bundled
    width."""
    transforms, seen, xsize = [], set(), width
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise DecodeError(f"corrupt WebP lossless data: transform {kind} twice")
        seen.add(kind)
        if kind in (0, 1):  # predictor, colour transform
            bits = br.read(3) + 2
            size = 1 << bits
            image = _decode_image(br, -(-xsize // size), -(-height // size), False)
            transforms.append((kind, xsize, bits, image))
        elif kind == 3:  # colour indexing
            count = br.read(8) + 1
            bits = 0 if count > 16 else 1 if count > 4 else 2 if count > 2 else 3
            table = _channels(_decode_image(br, count, 1, False))
            palette = _pack(np.cumsum(table, 0) & 255)  # each entry a delta from the one before
            transforms.append((kind, xsize, bits, palette))
            xsize = -(-xsize // (1 << bits))
        else:  # subtract green
            transforms.append((kind, xsize, 0, None))
    return transforms, _decode_image(br, xsize, height, True)


def decode_vp8l_stream(data: bytes, width: int, height: int, br: _Bits | None = None
                       ) -> np.ndarray:
    """(height, width) uint32 ARGB of a VP8L image stream (its transforms
    and entropy-coded image, no header; `br`, a reader already past a
    header), the transforms undone last read first."""
    br = br or _Bits(data)
    try:
        transforms, argb = _read_stream(br, width, height)
    except IndexError as e:  # a read past the zeros after the data
        raise DecodeError("truncated or corrupt WebP lossless data: it reads past its end") from e
    for kind, w, bits, aux in reversed(transforms):
        if kind == 3:
            argb = _unindex(argb, w, height, bits, aux)
            continue
        ch = _channels(argb)
        if kind == 0:
            ch = _unpredict(ch, w, height, bits, aux)
        elif kind == 1:
            ch = _uncross(ch, w, height, bits, aux)
        else:
            ch[:, 1] = (ch[:, 1] + ch[:, 2]) & 255
            ch[:, 3] = (ch[:, 3] + ch[:, 2]) & 255
        argb = _pack(ch)
    return argb.reshape(height, width)


def vp8l_header(data: bytes) -> tuple:
    """(width, height, alpha hint) of a VP8L bitstream's 5-byte header
    (signature 0x2F, 14-bit sizes minus one, version 0)."""
    if len(data) < 5:
        raise DecodeError("truncated WebP lossless data: no VP8L header")
    if data[0] != 0x2F:
        raise DecodeError("not a WebP lossless bitstream (no 0x2F signature)")
    bits = int.from_bytes(data[1:5], "little")
    if bits >> 29:
        raise DecodeError(f"WebP lossless version {bits >> 29} (only 0 exists)")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def decode_vp8l(data: bytes) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a VP8L bitstream (a "VP8L" chunk's payload)."""
    width, height, _ = vp8l_header(data)
    _check_size(width, height)
    br = _Bits(data)
    br.pos = 40
    argb = decode_vp8l_stream(data, width, height, br=br)
    return np.stack([(argb >> s) & 255 for s in (16, 8, 0, 24)], -1).astype(np.uint8)
