"""Block-compressed (BCn) texel decoding in numpy, as PIL decodes it.

A BCn image is a row-major grid of 4x4-texel blocks (8 bytes a block for
BC1 and BC4, 16 for the others); the blocks of the last column and row
reach past the image and are cut. Each decoder here takes an (N, 8) or
(N, 16) uint8 array of blocks and returns (N, 16, C) uint8 texels, texel
4*y + x of each block, all blocks at once: BC6H and BC7 blocks are grouped
by mode, and each group is decoded in one pass over its bit fields (no
Python loop over blocks or texels).

Two of PIL's decoders are copied, since their pixels differ:

  PIL's C decoder (libImaging/BcnDecode.c; DDS and FTEX):
    BC1       RGBA: colours 5:6:5 widened by bit replication; four colours,
              or three and transparent black where c0 <= c1;
    BC2, BC3  RGBA: BC1's colours always four (the c0 > c1 form), alpha
              4-bit explicit (x 17) or BC3's 8- or 6-value ramp;
    BC4       L: the ramp of BC3's alpha;
    BC5       RGB: two ramps into red and green, blue 0; BC5S reads its
              endpoints as signed bytes moved up by 128 (x ^ 0x80) and
              sets blue to 128;
    BC6H      RGB: the 14 modes of the format (and 4 reserved ones, black),
              endpoints as each mode packs them, delta endpoints sign
              extended and wrapped, unquantised to 16 bits (signed: 15 and
              a sign), interpolated without rounding, scaled by 31/64
              (signed: 31/32) to a half float, which is clamped to 0-1 and
              truncated after a float32 multiply by 255;
    BC7       RGBA: the 8 modes, the 2- and 3-subset partitions and their
              anchor texels, p-bits, rotation and the index-selection bit;
              mode byte 0 gives black.
  PIL's Python decoders (BlpImagePlugin.decode_dxt1/3/5; BLP2): DXT1/3/5
    with colours widened by a plain shift (no bit replication).
"""

from __future__ import annotations

import numpy as np

# 2-, 3- and 4-bit interpolation weights (out of 64) of BC6H and BC7
_WEIGHTS = {2: np.array([0, 21, 43, 64]),
            3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
            4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])}

# the 64 two-subset partitions (bit i: the subset of texel i)
_P2 = np.array([
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22])
_SUBSETS2 = (_P2[:, None] >> np.arange(16)) & 1
# the 64 three-subset partitions, a row of 16 texels each
_P3 = np.array([[int(c) for c in row] for row in (
    "0011001102212222", "0001001122112221", "0000200122112211", "0222002200110111",
    "0000000011221122", "0011001100220022", "0022002211111111", "0011001122112211",
    "0000000011112222", "0000111111112222", "0000111122222222", "0012001200120012",
    "0112011201120112", "0122012201220122", "0011011211221222", "0011200122002220",
    "0001001101121122", "0111001120012200", "0000112211221122", "0022002200221111",
    "0111011102220222", "0001000122212221", "0000001101220122", "0000110022102210",
    "0122012200110000", "0012001211222222", "0110122112210110", "0000011012211221",
    "0022110211020022", "0110011020022222", "0011012201220011", "0000200022112221",
    "0000000211221222", "0222002200120011", "0011001200220222", "0120012001200120",
    "0000111122220000", "0120120120120120", "0120201212010120", "0011220011220011",
    "0011112222000011", "0101010122222222", "0000000021212121", "0022112200221122",
    "0022001100220011", "0220122102201221", "0101222222220101", "0000212121212121",
    "0101010101012222", "0222011102220111", "0002111200021112", "0000211221122112",
    "0222011101110222", "0002111211120002", "0110011001102222", "0000000021122112",
    "0110011022222222", "0022001100110022", "0022112211220022", "0000000000002112",
    "0002000100020001", "0222122202221222", "0101222222222222", "0111201122012220")])
# the texel of each partition whose index is one bit short: subset 1's
# anchor (two subsets), subsets 1 and 2's (three); subset 0's is texel 0
_ANCHOR2 = np.array([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15,
    2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8,
    15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15])
_ANCHOR3 = np.array([[
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8,
    5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10,
    5, 10, 8, 13, 15, 12, 3, 3], [
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3, 15,
    6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8]])


def _subsets(ns: int, partition) -> np.ndarray:
    """(n, 16) subset of each texel under each block's partition."""
    if ns == 1:
        return np.zeros((partition.shape[0], 16), np.int64)
    return _SUBSETS2[partition] if ns == 2 else _P3[partition]


def _anchors(ns: int, partition) -> np.ndarray:
    """(n, 16) bool: the texels whose index is one bit short."""
    n = partition.shape[0]
    anchor = np.zeros((n, 16), bool)
    anchor[:, 0] = True
    rows = np.arange(n)
    if ns == 2:
        anchor[rows, _ANCHOR2[partition]] = True
    elif ns == 3:
        anchor[rows, _ANCHOR3[0][partition]] = True
        anchor[rows, _ANCHOR3[1][partition]] = True
    return anchor


# ---------------------------------------------------------------------------
# bits

def _bits(blocks) -> np.ndarray:
    """(N, 128) uint8: each block's bits, least significant of byte 0 first."""
    return np.unpackbits(np.ascontiguousarray(blocks, np.uint8), axis=1, bitorder="little")


def _fields(bits, pos: int, shape: tuple, n: int) -> np.ndarray:
    """(N, *shape) int64: consecutive n-bit fields from bit `pos` (shape ()
    one field a block)."""
    count = int(np.prod(shape))
    f = bits[:, pos:pos + count * n].reshape(bits.shape[0], count, n).astype(np.int64)
    return (f @ (1 << np.arange(n, dtype=np.int64))).reshape((bits.shape[0],) + shape)


def _indices(bits, pos: int, widths) -> np.ndarray:
    """(N, 16) int64: the texels' indices packed from bit `pos` in texel
    order, texel i `widths[:, i]` bits wide."""
    n = bits.shape[0]
    start = pos + np.cumsum(widths, 1) - widths
    k = np.arange(widths.max(initial=1))
    at = np.minimum(start[..., None] + k, 127)
    got = np.take_along_axis(bits, at.reshape(n, -1), 1).reshape(at.shape).astype(np.int64)
    return ((got << k) * (k < widths[..., None])).sum(-1)


# ---------------------------------------------------------------------------
# BC1-BC5

def _u16(blocks, at: int) -> np.ndarray:
    return blocks[:, at].astype(np.int64) | (blocks[:, at + 1].astype(np.int64) << 8)


def _u32(blocks, at: int) -> np.ndarray:
    return _u16(blocks, at) | (_u16(blocks, at + 2) << 16)


def _rgb565(c, replicate: bool) -> np.ndarray:
    """(N, 3) int64 of 5:6:5 colours: bit replication (PIL's C decoder's
    decode_565) or a plain shift (BlpImagePlugin.unpack_565)."""
    r, g, b = (c >> 11) << 3, ((c >> 5) & 63) << 2, (c & 31) << 3
    if replicate:
        r, g, b = r | r >> 5, g | g >> 6, b | b >> 5
    return np.stack([r, g, b], -1)


def _colour_block(blocks, four, replicate: bool) -> np.ndarray:
    """(N, 16, 4) int64 RGBA of BC1 colour blocks (8 bytes each); `four`
    forces the four-colour form (BC2, BC3, DXT3, DXT5)."""
    c0, c1 = _u16(blocks, 0), _u16(blocks, 2)
    p0, p1 = _rgb565(c0, replicate), _rgb565(c1, replicate)
    quad = (four | (c0 > c1))[:, None]
    p2 = np.where(quad, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(quad, (p0 + 2 * p1) // 3, 0)
    n = blocks.shape[0]
    alpha = np.full((n, 4, 1), 255, np.int64)
    alpha[:, 3, 0] = np.where(quad[:, 0], 255, 0)
    table = np.concatenate([np.stack([p0, p1, p2, p3], 1), alpha], 2)  # (N, 4, 4)
    code = (_u32(blocks, 4)[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(table, np.broadcast_to(code[..., None], (n, 16, 4)), 1)


def _ramp(blocks, signed: bool = False) -> np.ndarray:
    """(N, 16) int64: BC3's alpha block (8 bytes): two endpoints and a
    3-bit index a texel into their 8-value (a0 > a1) or 6-value ramp;
    `signed` reads the endpoints as BC5S does (int8 + 128)."""
    a0, a1 = blocks[:, 0].astype(np.int64), blocks[:, 1].astype(np.int64)
    if signed:
        a0, a1 = a0 ^ 0x80, a1 ^ 0x80
    k = np.arange(2, 8)
    eight = ((8 - k) * a0[:, None] + (k - 1) * a1[:, None]) // 7
    six = np.concatenate([((6 - k[:4]) * a0[:, None] + (k[:4] - 1) * a1[:, None]) // 5,
                          np.broadcast_to([0, 255], (a0.shape[0], 2))], 1)
    table = np.concatenate([a0[:, None], a1[:, None], np.where((a0 > a1)[:, None], eight, six)],
                           1)
    lut = _u16(blocks, 2) | (_u32(blocks, 4) << 16)
    code = (lut[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(table, code, 1)


def bc1(blocks) -> np.ndarray:
    """(N, 16, 4) uint8 RGBA of (N, 8) BC1 blocks, as PIL's C decoder."""
    return _colour_block(blocks, False, True).astype(np.uint8)


def bc2(blocks) -> np.ndarray:
    """(N, 16, 4) uint8 RGBA of (N, 16) BC2 blocks, as PIL's C decoder."""
    px = _colour_block(blocks[:, 8:], True, True)
    nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], -1).reshape(-1, 16)
    px[..., 3] = nib * 17
    return px.astype(np.uint8)


def bc3(blocks) -> np.ndarray:
    """(N, 16, 4) uint8 RGBA of (N, 16) BC3 blocks, as PIL's C decoder."""
    px = _colour_block(blocks[:, 8:], True, True)
    px[..., 3] = _ramp(blocks[:, :8])
    return px.astype(np.uint8)


def bc4(blocks) -> np.ndarray:
    """(N, 16, 1) uint8 L of (N, 8) BC4 blocks, as PIL's C decoder."""
    return _ramp(blocks)[..., None].astype(np.uint8)


def bc5(blocks, signed: bool = False) -> np.ndarray:
    """(N, 16, 3) uint8 RGB of (N, 16) BC5 (BC5S if `signed`) blocks, as
    PIL's C decoder: red and green from the two ramps, blue 0 (128)."""
    blue = np.full((blocks.shape[0], 16), 128 if signed else 0, np.int64)
    return np.stack([_ramp(blocks[:, :8], signed), _ramp(blocks[:, 8:], signed), blue],
                    -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# BC7

# ns subsets, pb partition bits, rb rotation bits, isb index-selection bits,
# cb colour bits, ab alpha bits, epb p-bit an endpoint, spb p-bit a subset,
# ib index bits, ib2 second (alpha) index bits
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))


# BC7's mode: the number of zero bits below the first byte's lowest set bit
_LOWEST_BIT = np.array([8] + [(v & -v).bit_length() - 1 for v in range(1, 256)])


def _bc7_mode(bits, mode: int) -> np.ndarray:
    """(n, 16, 4) int64 RGBA of BC7 blocks all of `mode`."""
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    n, ne = bits.shape[0], 2 * ns
    pos = mode + 1
    partition = _fields(bits, pos, (), pb)
    rotation = _fields(bits, pos + pb, (), rb)
    index_sel = _fields(bits, pos + pb + rb, (), isb)
    pos += pb + rb + isb
    ends = np.full((n, ne, 4), 255, np.int64)
    ends[..., :3] = _fields(bits, pos, (3, ne), cb).transpose(0, 2, 1)
    pos += 3 * ne * cb
    if ab:
        ends[..., 3] = _fields(bits, pos, (ne,), ab)
        pos += ne * ab
    chans = 4 if ab else 3
    if epb or spb:
        if epb:
            p = bits[:, pos:pos + ne].astype(np.int64)
            pos += ne
        else:
            p = np.repeat(bits[:, pos:pos + ns].astype(np.int64), 2, 1)
            pos += ns
        ends[..., :chans] = (ends[..., :chans] << 1) | p[..., None]
        cb, ab = cb + 1, ab + 1 if ab else 0
    ends[..., :3] = ((ends[..., :3] << (8 - cb)) | (ends[..., :3] >> (2 * cb - 8))) & 255
    if ab:
        ends[..., 3] = ((ends[..., 3] << (8 - ab)) | (ends[..., 3] >> (2 * ab - 8))) & 255
    anchor = _anchors(ns, partition)
    colour = _indices(bits, pos, ib - anchor)
    cw = _WEIGHTS[ib][colour]
    if ab and ib2:
        first = np.zeros((n, 16), np.int64)
        first[:, 0] = 1
        aw = _WEIGHTS[ib2][_indices(bits, pos + 16 * ib - ns, ib2 - first)]
        sel = index_sel[:, None] == 1
        cw, aw = np.where(sel, aw, cw), np.where(sel, cw, aw)
    else:
        aw = cw
    s = _subsets(ns, partition)
    e0 = np.take_along_axis(ends, (2 * s)[..., None].repeat(4, 2), 1)
    e1 = np.take_along_axis(ends, (2 * s + 1)[..., None].repeat(4, 2), 1)
    w = np.concatenate([np.repeat(cw[..., None], 3, 2), aw[..., None]], 2)
    px = ((64 - w) * e0 + w * e1 + 32) >> 6
    for r in (1, 2, 3):  # rotation swaps alpha with red, green or blue
        rows = rotation == r
        px[rows, :, r - 1], px[rows, :, 3] = px[rows, :, 3], px[rows, :, r - 1].copy()
    return px


def bc7(blocks) -> np.ndarray:
    """(N, 16, 4) uint8 RGBA of (N, 16) BC7 blocks, as PIL's C decoder."""
    blocks = np.asarray(blocks, np.uint8)
    out = np.zeros((blocks.shape[0], 16, 4), np.uint8)
    out[..., 3] = 255  # mode byte 0: opaque black
    mode = _LOWEST_BIT[blocks[:, 0]]
    for m in range(8):
        rows = np.nonzero(mode == m)[0]
        if rows.size:
            out[rows] = _bc7_mode(_bits(blocks[rows]), m)
    return out


# ---------------------------------------------------------------------------
# BC6H

# ns regions, tr transformed (delta) endpoints, pb partition bits, epb
# endpoint bits, rb/gb/bb delta bits of red, green, blue
_BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4),
              (2, 1, 5, 11, 4, 5, 4), (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
              (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5), (2, 1, 5, 8, 5, 5, 6),
              (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
              (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
# each mode's endpoint bits in stored order after its mode bits: field
# (r0 g0 b0 of region 0's first endpoint, r1.. its second, r2.. r3.. region
# 1's) and bit, "a-b" a run stored from bit a to bit b
_BC6_LAYOUT = (
    "g2:4 b2:4 b3:4 r0:0-9 g0:0-9 b0:0-9 r1:0-4 g3:4 g2:0-3 g1:0-4 b3:0 g3:0-3 b1:0-4 b3:1 "
    "b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3",
    "g2:5 g3:4 g3:5 r0:0-6 b3:0 b3:1 b2:4 g0:0-6 b2:5 b3:2 g2:4 b0:0-6 b3:3 b3:5 b3:4 r1:0-5 "
    "g2:0-3 g1:0-5 g3:0-3 b1:0-5 b2:0-3 r2:0-5 r3:0-5",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-4 r0:10 g2:0-3 g1:0-3 g0:10 b3:0 g3:0-3 b1:0-3 b0:10 b3:1 "
    "b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-3 r0:10 g3:4 g2:0-3 g1:0-4 g0:10 g3:0-3 b1:0-3 b0:10 b3:1 "
    "b2:0-3 r2:0-3 b3:0 b3:2 r3:0-3 g2:4 b3:3",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-3 r0:10 b2:4 g2:0-3 g1:0-3 g0:10 b3:0 g3:0-3 b1:0-4 b0:10 "
    "b2:0-3 r2:0-3 b3:1 b3:2 r3:0-3 b3:4 b3:3",
    "r0:0-8 b2:4 g0:0-8 g2:4 b0:0-8 b3:4 r1:0-4 g3:4 g2:0-3 g1:0-4 b3:0 g3:0-3 b1:0-4 b3:1 "
    "b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3",
    "r0:0-7 g3:4 b2:4 g0:0-7 b3:2 g2:4 b0:0-7 b3:3 b3:4 r1:0-5 g2:0-3 g1:0-4 b3:0 g3:0-3 "
    "b1:0-4 b3:1 b2:0-3 r2:0-5 r3:0-5",
    "r0:0-7 b3:0 b2:4 g0:0-7 g2:5 g2:4 b0:0-7 g3:5 b3:4 r1:0-4 g3:4 g2:0-3 g1:0-5 g3:0-3 "
    "b1:0-4 b3:1 b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3",
    "r0:0-7 b3:1 b2:4 g0:0-7 b2:5 g2:4 b0:0-7 b3:5 b3:4 r1:0-4 g3:4 g2:0-3 g1:0-4 b3:0 "
    "g3:0-3 b1:0-5 b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3",
    "r0:0-5 g3:4 b3:0 b3:1 b2:4 g0:0-5 g2:5 b2:5 b3:2 g2:4 b0:0-5 g3:5 b3:3 b3:5 b3:4 r1:0-5 "
    "g2:0-3 g1:0-5 g3:0-3 b1:0-5 b2:0-3 r2:0-5 r3:0-5",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-9 g1:0-9 b1:0-9",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-8 r0:10 g1:0-8 g0:10 b1:0-8 b0:10",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-7 r0:11-10 g1:0-7 g0:11-10 b1:0-7 b0:11-10",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-3 r0:15-10 g1:0-3 g0:15-10 b1:0-3 b0:15-10")


def _layout(text: str) -> np.ndarray:
    """(bits, 12) int64: the weight each stored bit adds to each endpoint
    value (r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3)."""
    slots = []
    for item in text.split():
        name, bits = item.split(":")
        e = "rgb".index(name[0]) + 3 * int(name[1])
        a, _, b = bits.partition("-")
        a, b = int(a), int(b or a)
        slots += [(e, k) for k in (range(a, b + 1) if b >= a else range(a, b - 1, -1))]
    m = np.zeros((len(slots), 12), np.int64)
    for i, (e, k) in enumerate(slots):
        m[i, e] = 1 << k
    return m


_BC6_PACKING = tuple(_layout(t) for t in _BC6_LAYOUT)


def _extend(v, prec):
    """Sign extension of the low `prec` bits of v, kept as 16-bit patterns."""
    prec = np.asarray(prec)
    neg = (v >> (prec - 1)) & 1
    return np.where(neg == 1, v | ((-1 << prec) & 0xFFFF), v) & 0xFFFF


def _unquantize(v, prec: int, signed: bool) -> np.ndarray:
    if not signed:
        if prec >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << prec) - 1, 0xFFFF,
                                            ((v << 15) + 0x4000) >> (prec - 1)))
    x = np.where(v >= 0x8000, v - 0x10000, v)
    if prec >= 16:
        return x
    mag = np.abs(x)
    mag = np.where(mag == 0, 0, np.where(mag >= (1 << (prec - 1)) - 1, 0x7FFF,
                                         ((mag << 15) + 0x4000) >> (prec - 1)))
    return np.where(x < 0, -mag, mag)


def _half_to_byte(v, signed: bool) -> np.ndarray:
    """PIL's bc6_finalize and bc6_clamp: the interpolated value scaled to
    half-float bits, clamped to 0-1, float32 x 255 truncated."""
    if signed:
        h = np.where(v < 0, 0x8000 | ((-v) * 31 // 32), v * 31 // 32)
    else:
        h = v * 31 // 64
    f = h.astype(np.uint16).view(np.float16).astype(np.float32)
    return np.where(f > 1, 255, np.where(f < 0, 0, (f * np.float32(255)).astype(np.int64)))


def _bc6_mode(bits, mode: int, signed: bool) -> np.ndarray:
    """(n, 16, 3) int64 RGB of BC6H blocks all of `mode`."""
    ns, tr, pb, epb, rb, gb, bb = _BC6_MODES[mode]
    packing = _BC6_PACKING[mode]
    start = 2 if mode < 2 else 5
    n, nep = bits.shape[0], 6 * ns
    ends = (bits[:, start:start + packing.shape[0]].astype(np.int64) @ packing)[:, :nep]
    pos = start + packing.shape[0]
    partition = _fields(bits, pos, (), pb)
    pos += pb
    delta_bits = np.tile([rb, gb, bb], ns * 2)[3:nep]
    if signed:
        ends[:, :3] = _extend(ends[:, :3], epb)
    if signed or tr:
        ends[:, 3:] = _extend(ends[:, 3:], delta_bits)
    if tr:
        ends[:, 3:] = (ends[:, 3:] + np.tile(ends[:, :3], ns * 2 - 1)) & ((1 << epb) - 1)
    ends = _unquantize(ends, epb, signed).reshape(n, 2 * ns, 3)
    ib = 3 if ns == 2 else 4
    idx = _indices(bits, pos, ib - _anchors(ns, partition))
    w = _WEIGHTS[ib][idx][..., None]
    s = _subsets(ns, partition)
    e0 = np.take_along_axis(ends, (2 * s)[..., None].repeat(3, 2), 1)
    e1 = np.take_along_axis(ends, (2 * s + 1)[..., None].repeat(3, 2), 1)
    return _half_to_byte((e0 * (64 - w) + e1 * w) >> 6, signed)


def bc6h(blocks, signed: bool = False) -> np.ndarray:
    """(N, 16, 3) uint8 RGB of (N, 16) BC6H blocks (BC6H_SF16 if
    `signed`), as PIL's C decoder."""
    blocks = np.asarray(blocks, np.uint8)
    code = blocks[:, 0].astype(np.int64) & 0x1F
    low = code & 3
    mode = np.where(low < 2, low, np.where(low == 2, 2 + (code >> 2), 10 + (code >> 2)))
    out = np.zeros((blocks.shape[0], 16, 3), np.uint8)  # reserved modes: black
    for m in range(14):
        rows = np.nonzero(mode == m)[0]
        if rows.size:
            out[rows] = _bc6_mode(_bits(blocks[rows]), m, signed)
    return out


# ---------------------------------------------------------------------------
# images

# kind -> (bytes a block, decoder, PIL mode)
KINDS = {"BC1": (8, bc1, "RGBA"), "BC2": (16, bc2, "RGBA"), "BC3": (16, bc3, "RGBA"),
         "BC4": (8, bc4, "L"), "BC5": (16, bc5, "RGB"),
         "BC5S": (16, lambda b: bc5(b, True), "RGB"), "BC6H": (16, bc6h, "RGB"),
         "BC6HS": (16, lambda b: bc6h(b, True), "RGB"), "BC7": (16, bc7, "RGBA")}


def block_count(width: int, height: int) -> int:
    return -(-width // 4) * -(-height // 4)


def tile(px, width: int, height: int) -> np.ndarray:
    """(height, width, C) texels of row-major (N, 16, C) blocks, the last
    column and row cut at the image's edge."""
    bw, bh = -(-width // 4), -(-height // 4)
    c = px.shape[-1]
    img = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, c)
    return img[:height, :width]


def decode_blocks(data, width: int, height: int, kind: str) -> tuple:
    """(pixels (height, width, C) uint8, PIL mode) of the blocks of `kind`
    at the start of `data`, which holds at least block_count of them."""
    size, fn, mode = KINDS[kind]
    n = block_count(width, height)
    blocks = np.frombuffer(data, np.uint8, n * size).reshape(n, size)
    return tile(fn(blocks), width, height), mode


def dxt_python(blocks, kind: str, alpha: bool = True) -> np.ndarray:
    """(N, 16, 3 or 4) uint8 texels of DXT1/DXT3/DXT5 blocks as PIL's
    Python decoders (BlpImagePlugin.decode_dxt1/3/5) make them: colours
    widened by a plain shift, DXT3/DXT5 always in the four-colour form,
    DXT1 RGB unless `alpha`."""
    blocks = np.asarray(blocks, np.uint8)
    if kind == "DXT1":
        px = _colour_block(blocks, False, False)
        return px[..., :4 if alpha else 3].astype(np.uint8)
    px = _colour_block(blocks[:, 8:], True, False)
    if kind == "DXT3":
        px[..., 3] = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], -1).reshape(-1, 16) * 17
    else:
        px[..., 3] = _ramp(blocks[:, :8])
    return px.astype(np.uint8)
