"""WebP lossy (VP8 key frame) decoding in numpy and the standard library.

`decode_vp8` returns the (H, W, 3) uint8 RGB pixels of a VP8 bitstream (the
payload of a "VP8 " chunk) as libwebp 1.6.0 outputs them in RGBA, which is
what PIL's WebP decoder gives.

Exact by RFC 6386: the boolean decoder; the frame header (segmentation
with per-segment quantiser and filter levels, the loop filter's type,
level, sharpness and reference/mode deltas, 1-8 token partitions); the
coefficient probabilities and their updates; skip flags; the 16x16 and
chroma modes (DC, V, H, TM) and the ten 4x4 modes, with the right column's
above-right pixels taken from the row above the macroblock and the 127
(above) and 129 (left) borders; dequantisation (the Y2 DC times 2, its AC
times 155/100 and at least 8, the chroma DC index capped at 117, that is
132); the inverse WHT and DCT; the simple and normal loop filters.

libwebp's own (src/dec, src/dsp): the order its filters run in (each
macroblock's left edge, inner vertical edges, top edge, inner horizontal
edges, in raster order; a frame of level 0 is not filtered whatever its
segments say), intra prediction from the unfiltered reconstruction,
"fancy" upsampling of the 4:2:0 chroma (upsampling.c: 9-3-3-1 weights
with its rounding, the edge rows and columns repeated), the 14-bit
fixed-point YUV to RGB of yuv.h (MultHi, VP8Clip8) and the crop of the
macroblock grid to the picture.

The boolean decode is the sequential part, a Python loop over bits; the
reconstruction runs a macroblock at a time (a 4x4 block at a time inside
B_PRED ones), the residuals' inverse transforms vectorised over the frame,
the loop filter along wavefronts of macroblocks (x + 2y: a macroblock's
filters touch its left and upper neighbours, which lie on earlier ones),
the upsampling and colour conversion over the frame.
"""

from __future__ import annotations

import numpy as np

from .image_decode import DecodeError, _check_size

_DC_TABLE = (4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21,
             22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38,
             39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
             59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78,
             79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104,
             106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140,
             143, 145, 148, 151, 154, 157)
_AC_TABLE = (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
             27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
             48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78,
             80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
             119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167,
             170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234,
             239, 245, 249, 254, 259, 264, 269, 274, 279, 284)
# RFC 6386 section 13.5: default_coeff_probs[4][8][3][11], then
# coeff_update_probs; section 11.5: kf_bmode_probs[10][10][9]
_COEF_PROBS = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
_COEF_UPDATE = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
_BMODE_PROBS = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418")
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)  # a position's band; 16: sentinel
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# modes: libwebp's numbering, the 16x16 ones sharing the 4x4 ones' numbers
DC, TM, VE, HE, RD, VR, LD, VL, HD, HU = range(10)
_BMODE_TREE = (-DC, 1, -TM, 2, -VE, 3, 4, 6, -HE, 5, -RD, -VR, -LD, 7, -VL, 8, -HD, -HU)
# the normalising shift of each range 1-255 (to 128-255)
_NORM = [0] + [8 - r.bit_length() for r in range(1, 256)]


class _Bool:
    """VP8's boolean decoder as libwebp runs it (bit_reader_utils):
    `rng` is the range minus one, `value` the bits loaded, of which the
    window is `value >> bits`. `eof` is set when a bit is read with every
    byte already loaded and fewer than 8 bits left, as libwebp sets it;
    every such read makes the frame's decode fail."""

    __slots__ = ("buf", "n", "pos", "value", "bits", "rng", "eof")

    def __init__(self, buf: bytes):
        self.buf, self.n, self.pos = buf, len(buf), 0
        self.value, self.bits, self.rng, self.eof = 0, -8, 254, False

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self.load()
        split = (self.rng * prob) >> 8
        if (self.value >> self.bits) > split:
            rng = self.rng - split
            self.value -= (split + 1) << self.bits
            b = 1
        else:
            rng = split + 1
            b = 0
        s = _NORM[rng]
        self.rng = (rng << s) - 1
        self.bits -= s
        return b

    def load(self) -> None:
        if self.pos + 7 <= self.n:
            self.value = (self.value << 56) | int.from_bytes(self.buf[self.pos:self.pos + 7], "big")
            self.pos += 7
            self.bits += 56
        elif self.pos < self.n:
            self.value = (self.value << 8) | self.buf[self.pos]
            self.pos += 1
            self.bits += 8
        else:
            self.value <<= 8
            self.bits += 8
            self.eof = True

    def literal(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, nbits: int) -> int:
        v = self.literal(nbits)
        return -v if self.bit(128) else v


def _large_value(br: _Bool, p) -> int:
    """A token's value past 1 (libwebp GetLargeValue: 2-4, the two short
    categories, then categories 3-6 of 3 to 11 extra bits)."""
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    cat = 2 * br.bit(p[8])
    cat += br.bit(p[9 + cat // 2])
    v = 0
    for prob in _CATS[cat]:
        v = 2 * v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bool, bands, ctx: int, dq0: int, dq1: int, n: int, out, o: int) -> int:
    """One block's tokens from position n (libwebp GetCoeffs): dequantised
    coefficients into out[o:o + 16] (raster order), as int16; returns the
    position after the last token read (16 after a run of zeros to the
    end), which is what the neighbours' contexts and the transform choice
    read."""
    p = bands[n][ctx]
    pos, value, bits, rng = br.pos, br.value, br.bits, br.rng
    norm = _NORM
    while n < 16:
        # bit(p[0]): more tokens?
        if bits < 0:
            br.pos, br.value, br.bits = pos, value, bits
            br.load()
            pos, value, bits = br.pos, br.value, br.bits
        split = (rng * p[0]) >> 8
        if (value >> bits) > split:
            rng -= split
            value -= (split + 1) << bits
            s = norm[rng]
            rng = (rng << s) - 1
            bits -= s
        else:
            rng = split + 1
            s = norm[rng]
            rng = (rng << s) - 1
            bits -= s
            break
        while True:  # bit(p[1]): a zero?
            if bits < 0:
                br.pos, br.value, br.bits = pos, value, bits
                br.load()
                pos, value, bits = br.pos, br.value, br.bits
            split = (rng * p[1]) >> 8
            if (value >> bits) > split:
                rng -= split
                value -= (split + 1) << bits
                s = norm[rng]
                rng = (rng << s) - 1
                bits -= s
                break
            rng = split + 1
            s = norm[rng]
            rng = (rng << s) - 1
            bits -= s
            n += 1
            if n == 16:
                br.pos, br.value, br.bits, br.rng = pos, value, bits, rng
                return 16
            p = bands[n][0]
        nxt = bands[n + 1]
        # bit(p[2]): one, or larger
        if bits < 0:
            br.pos, br.value, br.bits = pos, value, bits
            br.load()
            pos, value, bits = br.pos, br.value, br.bits
        split = (rng * p[2]) >> 8
        if (value >> bits) > split:
            rng -= split
            value -= (split + 1) << bits
            s = norm[rng]
            rng = (rng << s) - 1
            bits -= s
            br.pos, br.value, br.bits, br.rng = pos, value, bits, rng
            v = _large_value(br, p)
            pos, value, bits, rng = br.pos, br.value, br.bits, br.rng
            p = nxt[2]
        else:
            rng = split + 1
            s = norm[rng]
            rng = (rng << s) - 1
            bits -= s
            v = 1
            p = nxt[1]
        # the sign, at probability one half
        if bits < 0:
            br.pos, br.value, br.bits = pos, value, bits
            br.load()
            pos, value, bits = br.pos, br.value, br.bits
        split = rng >> 1
        if (value >> bits) > split:
            rng -= split
            value -= (split + 1) << bits
            v = -v
        else:
            rng = split + 1
        s = norm[rng]
        rng = (rng << s) - 1
        bits -= s
        c = v * (dq1 if n else dq0)
        out[o + _ZIGZAG[n]] = ((c + 32768) & 65535) - 32768
        n += 1
    br.pos, br.value, br.bits, br.rng = pos, value, bits, rng
    return n


def vp8_header(data: bytes) -> tuple:
    """(width, height, first partition's size) of a VP8 key frame's header
    (libwebp VP8GetInfo): a key frame, profile 0-3, shown, the start code
    9D 01 2A, sizes not 0, the first partition shorter than the data."""
    if len(data) < 10:
        raise DecodeError("truncated WebP lossy data: no frame header")
    bits = int.from_bytes(data[:3], "little")
    if data[3:6] != b"\x9d\x01\x2a":
        raise DecodeError("not a VP8 key frame (no start code)")
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= len(data):
        raise DecodeError("VP8: not a shown key frame, or inconsistent sizes")
    width = int.from_bytes(data[6:8], "little") & 0x3FFF
    height = int.from_bytes(data[8:10], "little") & 0x3FFF
    if not width or not height:
        raise DecodeError("VP8: a picture of zero size")
    return width, height, bits >> 5


def dequant(q: int, deltas) -> tuple:
    """The dequantisation factors of quantiser index `q` and the frame's
    deltas (y1 DC, y2 DC, y2 AC, uv DC, uv AC): (y1 dc, y1 ac, y2 dc, y2 ac,
    uv dc, uv ac); each index clipped to 0-127, the chroma DC's to 117."""
    dy1, dy2dc, dy2ac, duvdc, duvac = deltas

    def clip(v, top=127):
        return min(max(v, 0), top)
    y2ac = _AC_TABLE[clip(q + dy2ac)] * 101581 >> 16  # x * 155 / 100 for x up to 284
    return (_DC_TABLE[clip(q + dy1)], _AC_TABLE[clip(q)], _DC_TABLE[clip(q + dy2dc)] * 2,
            max(y2ac, 8), _DC_TABLE[clip(q + duvdc, 117)], _AC_TABLE[clip(q + duvac)])


class _Header:
    """The first partition's frame header (libwebp VP8GetHeaders)."""

    def __init__(self, br: _Bool):
        br.bit(128)  # colour space
        br.bit(128)  # clamping type (libwebp always clamps)
        self.use_segment = br.bit(128)
        self.update_map, self.absolute = 0, 1
        self.seg_quant, self.seg_filter = [0] * 4, [0] * 4
        self.seg_probs = [255] * 3
        if self.use_segment:
            self.update_map = br.bit(128)
            if br.bit(128):  # update the segments' data
                self.absolute = br.bit(128)
                self.seg_quant = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
                self.seg_filter = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
        if br.eof:
            raise DecodeError("truncated VP8 data: the segment header")
        self.simple = br.bit(128)
        self.level = br.literal(6)
        self.sharpness = br.literal(3)
        self.ref_delta, self.mode_delta = [0] * 4, [0] * 4
        self.use_delta = br.bit(128)
        if self.use_delta and br.bit(128):
            for deltas in (self.ref_delta, self.mode_delta):
                for i in range(4):
                    if br.bit(128):
                        deltas[i] = br.signed(6)
        if br.eof:
            raise DecodeError("truncated VP8 data: the filter header")
        self.filter_type = 0 if self.level == 0 else 1 if self.simple else 2

    def quant(self, br: _Bool) -> list:
        """VP8ParseQuant: each segment's dequantisation factors."""
        base = br.literal(7)
        deltas = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]
        return [dequant(self.seg_quant[s] + (0 if self.absolute else base)
                        if self.use_segment else base, deltas) for s in range(4)]

    def filter_strengths(self) -> list:
        """PrecomputeFilterStrengths: (limit, interior limit, hev
        threshold) by segment and by 16x16 (0) or 4x4 (1) prediction."""
        out = []
        for s in range(4):
            base = self.level
            if self.use_segment:
                base = self.seg_filter[s] + (0 if self.absolute else self.level)
            row = []
            for i4 in (0, 1):
                level = base
                if self.use_delta:
                    level += self.ref_delta[0] + (self.mode_delta[0] if i4 else 0)
                level = min(max(level, 0), 63)
                if level == 0:
                    row.append((0, 0, 0))
                    continue
                ilevel = level
                if self.sharpness:
                    ilevel >>= 2 if self.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - self.sharpness)
                ilevel = max(ilevel, 1)
                hev = 2 if level >= 40 else 1 if level >= 15 else 0
                row.append((2 * level + ilevel, ilevel, hev))
            out.append(row)
        return out


def _token_probs(br: _Bool) -> list:
    """The coefficient probabilities after the frame's updates, as
    bands[type][position 0-16][context] -> 11 probabilities."""
    probs = []
    i = 0
    for _ in range(4):
        by_band = []
        for _ in range(8):
            ctxs = []
            for _ in range(3):
                row = []
                for _ in range(11):
                    row.append(br.literal(8) if br.bit(_COEF_UPDATE[i]) else _COEF_PROBS[i])
                    i += 1
                ctxs.append(row)
            by_band.append(ctxs)
        probs.append([by_band[b] for b in _BANDS])
    return probs


def _parse_partitions(data: bytes, start: int, count: int) -> list:
    """The token partitions' bytes (libwebp ParsePartitions): 1, 2, 4 or 8,
    the sizes of all but the last in 3-byte fields after the first
    partition (cut to what is left), the last holding the rest and at
    least one byte."""
    part = start + 3 * (count - 1)
    if part > len(data):
        raise DecodeError("truncated VP8 data: the partition sizes")
    left = len(data) - part
    out = []
    for k in range(count - 1):
        size = min(int.from_bytes(data[start + 3 * k:start + 3 * k + 3], "little"), left)
        out.append(data[part:part + size])
        part += size
        left -= size
    if part >= len(data):
        raise DecodeError("truncated VP8 data: an empty last partition")
    out.append(data[part:])
    return out


class _MB:
    """A macroblock's modes and coefficients (libwebp VP8MBData)."""

    __slots__ = ("segment", "skip", "i4", "ymodes", "uvmode", "coeffs", "zero")


def _parse_modes(br: _Bool, hdr: _Header, use_skip: bool, skip_prob: int, mb_w: int, mb_h: int):
    """Every macroblock's segment, skip flag and prediction modes, from the
    first partition (libwebp ParseIntraMode; the 4x4 modes' contexts are
    the modes above and to the left, B_DC_PRED outside the frame and
    implied by a 16x16 mode)."""
    bprobs = _BMODE_PROBS
    mbs = []
    top = [DC] * (4 * mb_w)
    for _ in range(mb_h):
        left = [DC] * 4
        for mx in range(mb_w):
            mb = _MB()
            if hdr.update_map:
                sp = hdr.seg_probs
                mb.segment = br.bit(sp[1]) if not br.bit(sp[0]) else 2 + br.bit(sp[2])
            else:
                mb.segment = 0
            mb.skip = br.bit(skip_prob) if use_skip else 0
            mb.i4 = not br.bit(145)
            if not mb.i4:
                if br.bit(156):
                    mode = TM if br.bit(128) else HE
                else:
                    mode = VE if br.bit(163) else DC
                mb.ymodes = mode
                top[4 * mx:4 * mx + 4] = [mode] * 4
                left = [mode] * 4
            else:
                modes = []
                for y in range(4):
                    ymode = left[y]
                    for x in range(4):
                        base = (top[4 * mx + x] * 10 + ymode) * 9
                        i = _BMODE_TREE[br.bit(bprobs[base])]
                        while i > 0:
                            i = _BMODE_TREE[2 * i + br.bit(bprobs[base + i])]
                        ymode = -i
                        top[4 * mx + x] = ymode
                        modes.append(ymode)
                    left[y] = ymode
                mb.ymodes = modes
            mb.uvmode = DC if not br.bit(142) else VE if not br.bit(114) else (
                TM if br.bit(183) else HE)
            mbs.append(mb)
    if br.eof:
        raise DecodeError("truncated VP8 data: the first partition ends early")
    return mbs


def _wht(dc) -> list:
    """The inverse Walsh-Hadamard transform of the Y2 block: each Y
    block's DC."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        for k, v in enumerate(((a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3)):
            out[4 * i + k] = ((v + 32768) & 65535) - 32768
    return out


def _parse_tokens(parts, mbs, quant, probs, mb_w: int, mb_h: int) -> None:
    """Every macroblock's dequantised coefficients (libwebp ParseResiduals,
    row y from partition y mod count): mb.coeffs, 24 blocks of 16 in raster
    order (16 Y, 4 U, 4 V), or None; mb.zero, whether no block has a
    coefficient (then the inner edges go unfiltered unless it is B_PRED)."""
    readers = [_Bool(p) for p in parts]
    nz_top, nz_dc_top = [0] * mb_w, [0] * mb_w
    i16_ac, y2, uv, i4 = probs
    for my in range(mb_h):
        br = readers[my % len(readers)]
        nz_left = nz_dc_left = 0
        for mx in range(mb_w):
            mb = mbs[my * mb_w + mx]
            if mb.skip:
                mb.coeffs, mb.zero = None, True
                nz_top[mx] = nz_left = 0
                if not mb.i4:
                    nz_dc_top[mx] = nz_dc_left = 0
                continue
            q = quant[mb.segment]
            out = [0] * 384
            codes = 0
            if not mb.i4:
                dc = [0] * 16
                nz = _coeffs(br, y2, nz_dc_top[mx] + nz_dc_left, q[2], q[3], 0, dc, 0)
                nz_dc_top[mx] = nz_dc_left = int(nz > 0)
                for k, v in enumerate(_wht(dc) if nz > 1 else [(dc[0] + 3) >> 3] * 16):
                    out[16 * k] = v
                first, ac = 1, i16_ac
            else:
                first, ac = 0, i4
            tnz, lnz = nz_top[mx] & 15, nz_left & 15
            for y in range(4):
                left = lnz & 1
                for x in range(4):
                    o = 16 * (4 * y + x)
                    nz = _coeffs(br, ac, left + (tnz & 1), q[0], q[1], first, out, o)
                    left = int(nz > first)
                    tnz = (tnz >> 1) | (left << 7)
                    codes |= nz > 1 or out[o] != 0
                tnz >>= 4
                lnz = (lnz >> 1) | (left << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = nz_top[mx] >> (4 + ch), nz_left >> (4 + ch)
                for y in range(2):
                    left = lnz & 1
                    for x in range(2):
                        o = 256 + 64 * (ch // 2) + 16 * (2 * y + x)
                        nz = _coeffs(br, uv, left + (tnz & 1), q[4], q[5], 0, out, o)
                        left = int(nz > 0)
                        tnz = (tnz >> 1) | (left << 3)
                        codes |= nz > 1 or out[o] != 0
                    tnz >>= 2
                    lnz = (lnz >> 1) | (left << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            nz_top[mx], nz_left = out_t, out_l
            mb.coeffs, mb.zero = out, not codes
        if br.eof:
            raise DecodeError("truncated VP8 data: a token partition ends early")


def _residuals(mbs) -> np.ndarray:
    """(macroblocks, 24, 4, 4) int32: each block's inverse DCT (libwebp
    TransformOne, (v + 4) >> 3 before the prediction is added), zeros for a
    skipped macroblock."""
    coef = np.zeros((len(mbs), 24, 16), np.int64)
    for i, mb in enumerate(mbs):
        if mb.coeffs is not None:
            coef[i] = np.asarray(mb.coeffs).reshape(24, 16)
    c = coef.reshape(-1, 4, 4)  # [block, row, column]

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    # vertical pass: each column's 4 coefficients (rows 0-3)
    a, b = c[:, 0] + c[:, 2], c[:, 0] - c[:, 2]
    cc, d = mul2(c[:, 1]) - mul1(c[:, 3]), mul1(c[:, 1]) + mul2(c[:, 3])
    tmp = np.stack([a + d, b + cc, b - cc, a - d], 1)  # [block, output row, column]
    dc = tmp[:, :, 0] + 4
    a, b = dc + tmp[:, :, 2], dc - tmp[:, :, 2]
    cc, d = mul2(tmp[:, :, 1]) - mul1(tmp[:, :, 3]), mul1(tmp[:, :, 1]) + mul2(tmp[:, :, 3])
    out = np.stack([a + d, b + cc, b - cc, a - d], 2) >> 3
    return out.reshape(len(mbs), 24, 4, 4).astype(np.int32)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode, top, left, tl):
    """A 4x4 block's prediction (libwebp dec.c), row-major 16 values:
    `top` the 8 pixels above (the last four above-right), `left` the 4 to
    the left, `tl` the one above-left."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [v] * 16
    if mode == TM:
        out = []
        for y in range(4):
            for t in top[:4]:
                v = t + left[y] - tl
                out.append(0 if v < 0 else 255 if v > 255 else v)
        return out
    if mode == VE:
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == HE:
        rows = (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))
        return [v for v in rows for _ in range(4)]
    if mode == RD:
        r = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I), _avg3(B, A, X),
             _avg3(C, B, A), _avg3(D, C, B)]  # along anti-diagonals from the bottom left
        return [r[3 - y + x] for y in range(4) for x in range(4)]
    if mode == LD:
        r = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G),
             _avg3(F, G, H), _avg3(G, H, H)]
        return [r[x + y] for y in range(4) for x in range(4)]
    if mode == VR:
        return [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D),
                _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(J, I, X), _avg2(X, A), _avg2(A, B), _avg2(B, C),
                _avg3(K, J, I), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]
    if mode == VL:
        return [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E),
                _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg2(B, C), _avg2(C, D), _avg2(D, E), _avg3(E, F, G),
                _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(F, G, H)]
    if mode == HD:
        return [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C),
                _avg2(J, I), _avg3(J, I, X), _avg2(I, X), _avg3(I, X, A),
                _avg2(K, J), _avg3(K, J, I), _avg2(J, I), _avg3(J, I, X),
                _avg2(L, K), _avg3(L, K, J), _avg2(K, J), _avg3(K, J, I)]
    # HU
    return [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L),
            _avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L),
            _avg2(K, L), _avg3(K, L, L), L, L,
            L, L, L, L]


def _pred_block(mode: int, top, left, tl: int, size: int, mx: int, my: int) -> np.ndarray:
    """A 16x16 or 8x8 block's prediction (DC, V, H, TM; DC from the pixels
    present only, 128 with none)."""
    if mode == DC:
        if mx and my:
            v = (int(top.sum()) + int(left.sum()) + size) >> (5 if size == 16 else 4)
        elif my:
            v = (int(top.sum()) + size // 2) >> (4 if size == 16 else 3)
        elif mx:
            v = (int(left.sum()) + size // 2) >> (4 if size == 16 else 3)
        else:
            v = 128
        return np.full((size, size), v, np.int32)
    if mode == VE:
        return np.broadcast_to(top, (size, size))
    if mode == HE:
        return np.broadcast_to(left[:, None], (size, size))
    return np.clip(top[None, :] + left[:, None] - tl, 0, 255)


def _reconstruct(mbs, res, mb_w: int, mb_h: int):
    """The unfiltered Y, U and V planes, a macroblock at a time in raster
    order (libwebp ReconstructRow): prediction from the reconstructed
    pixels above and to the left (127 above the frame, 129 left of it, the
    above-left 127 on the top row and 129 down the left column), plus each
    block's residual, clipped."""
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.int32)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.int32)
    V = np.zeros_like(U)
    for my in range(mb_h):
        for mx in range(mb_w):
            mb = mbs[my * mb_w + mx]
            r = res[my * mb_w + mx]
            y0, x0 = 16 * my, 16 * mx
            if my:
                top = Y[y0 - 1, x0:x0 + 16]
                tl = int(Y[y0 - 1, x0 - 1]) if mx else 129
            else:
                top, tl = np.full(16, 127, np.int32), 127
            left = Y[y0:y0 + 16, x0 - 1] if mx else np.full(16, 129, np.int32)
            if not mb.i4:
                pred = _pred_block(mb.ymodes, top, left, tl, 16, mx, my)
                blocks = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + blocks, 0, 255)
            else:
                if my == 0:
                    right = [127] * 4
                elif mx == mb_w - 1:
                    right = [int(Y[y0 - 1, x0 + 15])] * 4
                else:
                    right = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
                # the block with a border: row 0 above it, column 0 left of it
                grid = [[tl] + top.tolist() + right]
                grid += [[v] + [0] * 20 for v in left.tolist()]
                rl = r[:16].tolist()
                for n, mode in enumerate(mb.ymodes):
                    by, bx = 4 * (n >> 2) + 1, 4 * (n & 3) + 1
                    above = grid[by - 1]
                    t8 = above[bx:bx + 8] if bx < 13 or by == 1 else above[bx:bx + 4] + right
                    pred = _pred4(mode, t8, [grid[by + k][bx - 1] for k in range(4)],
                                  above[bx - 1])
                    rb = rl[n]
                    for k in range(4):
                        row = grid[by + k]
                        rk = rb[k]
                        for j in range(4):
                            v = pred[4 * k + j] + rk[j]
                            row[bx + j] = 0 if v < 0 else 255 if v > 255 else v
                Y[y0:y0 + 16, x0:x0 + 16] = np.array(grid)[1:, 1:17]
            c0, cx = 8 * my, 8 * mx
            for plane, first in ((U, 16), (V, 20)):
                if my:
                    top = plane[c0 - 1, cx:cx + 8]
                    tl = int(plane[c0 - 1, cx - 1]) if mx else 129
                else:
                    top, tl = np.full(8, 127, np.int32), 127
                left = plane[c0:c0 + 8, cx - 1] if mx else np.full(8, 129, np.int32)
                pred = _pred_block(mb.uvmode, top, left, tl, 8, mx, my)
                blocks = r[first:first + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                plane[c0:c0 + 8, cx:cx + 8] = np.clip(pred + blocks, 0, 255)
    return Y, U, V


def _edge_filter(g, t2, it, hev_t, kind: str):
    """Filter (n, 8) lines p3 p2 p1 p0 q0 q1 q2 q3 across an edge in place
    (libwebp dsp/dec.c): "simple" (NeedsFilter, DoFilter2), "mb" (a
    macroblock edge: NeedsFilter2, then DoFilter2 where the edge has high
    variance, else DoFilter6) or "inner" (DoFilter2 or DoFilter4); t2 is
    2 * limit + 1, `it` the interior limit, `hev_t` the variance
    threshold, each (n,)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (g[:, k] for k in range(8))
    on = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind != "simple":
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            on &= np.abs(a - b) <= it
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
        two = on & hev
        rest = on & ~hev
    else:
        two, rest = on, None
    out = g.copy()
    if two.any():
        a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        out[:, 3] = np.where(two, np.clip(p0 + a2, 0, 255), out[:, 3])
        out[:, 4] = np.where(two, np.clip(q0 - a1, 0, 255), out[:, 4])
    if rest is not None and rest.any():
        if kind == "mb":
            a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
            a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
            new = (p2 + a3, p1 + a2, p0 + a1, q0 - a1, q1 - a2, q2 - a3)
            cols = (1, 2, 3, 4, 5, 6)
        else:
            a = 3 * (q0 - p0)
            a1 = np.clip((a + 4) >> 3, -16, 15)
            a2 = np.clip((a + 3) >> 3, -16, 15)
            a3 = (a1 + 1) >> 1
            new = (p1 + a3, p0 + a2, q0 - a1, q1 - a3)
            cols = (2, 3, 4, 5)
        for c, v in zip(cols, new):
            out[:, c] = np.where(rest, np.clip(v, 0, 255), out[:, c])
    return out


def _loop_filter(planes, mbs, hdr: _Header, mb_w: int, mb_h: int) -> None:
    """The loop filter over the frame in place (libwebp DoFilter), along
    wavefronts x + 2y of macroblocks with a filter limit above 0."""
    strengths = hdr.filter_strengths()
    info = np.array([strengths[mb.segment][int(mb.i4)] + (int(mb.i4 or not mb.zero),)
                     for mb in mbs], np.int64).reshape(mb_h, mb_w, 4)
    my, mx = np.mgrid[0:mb_h, 0:mb_w]
    todo = info[:, :, 0] > 0
    wave = (mx + 2 * my)[todo]
    xs, ys, inf = mx[todo], my[todo], info[todo]
    order = np.argsort(wave, kind="stable")
    xs, ys, inf, wave = xs[order], ys[order], inf[order], wave[order]
    cuts = np.flatnonzero(np.diff(wave)) + 1
    kinds = [(planes[0], 16)] + ([(planes[1], 8), (planes[2], 8)] if hdr.filter_type == 2 else [])
    lines8 = np.arange(-4, 4)
    for sel in np.split(np.arange(xs.size), cuts):
        x, y, (limit, ilevel, hev, inner) = xs[sel], ys[sel], inf[sel].T
        for plane, size in kinds:
            w = plane.shape[1]
            flat = plane.reshape(-1)
            k = np.arange(size)

            def run(rows, cols, horizontal, lim, it, ht, kind, on):
                """Filter the edges of the chosen macroblocks: `rows`,
                `cols` (n, size) the pixel just past each edge point."""
                if not on.any():
                    return
                rows, cols = rows[on].ravel(), cols[on].ravel()
                if horizontal:  # across a vertical edge: a row of 8
                    idx = rows[:, None] * w + cols[:, None] + lines8
                else:
                    idx = (rows[:, None] + lines8) * w + cols[:, None]
                rep = lambda v: np.repeat(v[on], size)  # noqa: E731
                flat[idx] = _edge_filter(flat[idx], 2 * rep(lim) + 1, rep(it), rep(ht), kind)

            simple = hdr.filter_type == 1
            ymb, xmb = y[:, None] * size, x[:, None] * size
            vert = (ymb + k, np.broadcast_to(xmb, (x.size, size)))
            # the macroblock's left edge, then its inner vertical edges
            run(vert[0], vert[1], True, limit + 4, ilevel, hev, "simple" if simple else "mb",
                x > 0)
            for e in range(4, size, 4):
                run(vert[0], vert[1] + e, True, limit, ilevel, hev,
                    "simple" if simple else "inner", inner > 0)
            horiz = (np.broadcast_to(ymb, (x.size, size)), xmb + k)
            run(horiz[0], horiz[1], False, limit + 4, ilevel, hev, "simple" if simple else "mb",
                y > 0)
            for e in range(4, size, 4):
                run(horiz[0] + e, horiz[1], False, limit, ilevel, hev,
                    "simple" if simple else "inner", inner > 0)


def _to_rgb(Y, U, V, width: int, height: int) -> np.ndarray:
    """libwebp's fancy upsampling (upsampling.c UpsampleRgbaLinePair) and
    YUV to RGB (yuv.h) of the planes cropped to the picture: each output
    row takes its nearest chroma row and the next nearest (the edge row
    repeated), each column of a row pair the 9-3-3-1 blend with libwebp's
    two-step rounding, the first and (even widths) last columns 3-1."""
    y = Y[:height, :width].astype(np.int64)
    cw, chh = (width + 1) // 2, (height + 1) // 2
    rows = np.arange(height)
    near = np.where(rows % 2, (rows - 1) // 2, rows // 2)
    far = np.where(rows % 2, (rows + 1) // 2, rows // 2 - 1)
    far[0] = 0
    far = np.minimum(far, chh - 1)
    chans = []
    for P in (U, V):
        p = P[:chh, :cw].astype(np.int64)
        n, f = p[near], p[far]
        out = np.empty((height, width), np.int64)
        out[:, 0] = (3 * n[:, 0] + f[:, 0] + 2) >> 2
        if cw > 1:
            tl, t, l, c = n[:, :-1], n[:, 1:], f[:, :-1], f[:, 1:]
            d12 = (tl + 3 * t + 3 * l + c + 8) >> 3
            d03 = (3 * tl + t + l + 3 * c + 8) >> 3
            odd = (d12 + tl) >> 1  # column 2x - 1
            even = (d03 + t) >> 1  # column 2x
            m = (width - 1) // 2
            out[:, 1:2 * m:2] = odd[:, :m]
            out[:, 2:2 * m + 1:2] = even[:, :m]
        if width % 2 == 0:
            out[:, width - 1] = (3 * n[:, cw - 1] + f[:, cw - 1] + 2) >> 2
        chans.append(out)
    u, v = chans

    def mult_hi(a, k):
        return (a * k) >> 8

    def clip8(a):
        return np.where((a & ~16383) == 0, a >> 6, np.where(a < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def decode_vp8(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a VP8 key frame (a "VP8 " chunk's payload)."""
    data = bytes(data)
    width, height, first = vp8_header(data)
    _check_size(width, height)
    if first > len(data) - 10:
        raise DecodeError("truncated VP8 data: the first partition")
    br = _Bool(data[10:10 + first])
    hdr = _Header(br)
    count = 1 << br.literal(2)
    parts = _parse_partitions(data, 10 + first, count)
    quant = hdr.quant(br)
    br.bit(128)  # refresh_entropy_probs, which a lone key frame does not use
    probs = _token_probs(br)
    use_skip = br.bit(128)
    skip_prob = br.literal(8) if use_skip else 0
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    mbs = _parse_modes(br, hdr, use_skip, skip_prob, mb_w, mb_h)
    _parse_tokens(parts, mbs, quant, probs, mb_w, mb_h)
    Y, U, V = _reconstruct(mbs, _residuals(mbs), mb_w, mb_h)
    if hdr.filter_type:
        _loop_filter((Y, U, V), mbs, hdr, mb_w, mb_h)
    return _to_rgb(Y, U, V, width, height)
