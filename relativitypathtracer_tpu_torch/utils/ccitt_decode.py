"""CCITT bilevel decoding (TIFF compressions 2, 3 and 4) as libtiff's
tif_fax3.c decodes a strip or tile, for utils/tiff_decode.

PIL hands these compressions to libtiff, so this follows libtiff's state
machine step by step, its leniency included:

  2  CCITT RLE (Fax3DecodeRLE): each row modified-Huffman runs, white
     first, then the bits to the next byte boundary skipped; no EOLs
  3  Group 3 (Fax3Decode1D, or Fax3Decode2D under T4Options bit 0): each
     row after an EOL (any zero bits, then a 1), 2D rows tagged by a bit
     after it (1: a 1D row, 0: coded against the row above)
  4  Group 4 (Fax4Decode): 2D rows against the row above, the first
     against a white row

The code tables are libtiff's (mkg3states.c: T.4's terminating, make-up
and extended make-up codes up to 2560, an EOL as 11 zero bits, the 2D mode
codes with 0000000 an EOL and 0000001 an extension), looked up 12 (white),
13 (black) and 7 (2D mode) bits at a time, so a pattern no code starts
is a lookup of width 0. A bad code is what libtiff only reports: the row
is closed there (CLEANUP_RUNS: the runs cut or padded to the row's width)
and decoding goes on. Past the data the bits read as 0 while any bit is
left of the last lookup (NeedBits' padding); a lookup with none left is a
premature end (as is Group 4's EOL before the strip's last row). There
libtiff leaves the rest of the strip unwritten, and PIL then fails or
returns what its strip buffer held, which differs from run to run: the
port refuses such a strip. A run array past libtiff's size fails it, as
in libtiff. Runs fill the row
black (1 bits) and white (0 bits) as _TIFFFax3fillruns does, clamping the
runs it is given (which the next row reads as its reference).
"""

from __future__ import annotations

import functools

import numpy as np

from .image_decode import DecodeError

# T.4's codes, MSB first: (run length, code)
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
               "000000011111").split()

# table states (mkg3states.c)
_NULL, _PASS, _HORIZ, _V0, _VR, _VL, _EXT, _TERMW, _TERMB, _MAKEUPW, _MAKEUPB, _MAKEUP, _EOL = \
    range(13)


def _fill(table, size: int, codes, state: int) -> None:
    """mkg3states.c FillTable: every `size`-bit pattern a code starts, as
    (state, width, param)."""
    for code, param in codes:
        w = len(code)
        base = int(code, 2) << (size - w)
        for k in range(1 << (size - w)):
            table[base + k] = (state, w, param)


@functools.cache
def _tables():
    white, black, main = ([(_NULL, 0, 0)] * (1 << n) for n in (12, 13, 7))
    ext = [(c, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
    _fill(white, 12, [(c, 64 * (i + 1)) for i, c in enumerate(_WHITE_MAKEUP)], _MAKEUPW)
    _fill(white, 12, ext, _MAKEUP)
    _fill(white, 12, [(c, i) for i, c in enumerate(_WHITE_TERM)], _TERMW)
    _fill(white, 12, [("0" * 11, 0)], _EOL)
    _fill(black, 13, [(c, 64 * (i + 1)) for i, c in enumerate(_BLACK_MAKEUP)], _MAKEUPB)
    _fill(black, 13, ext, _MAKEUP)
    _fill(black, 13, [(c, i) for i, c in enumerate(_BLACK_TERM)], _TERMB)
    _fill(black, 13, [("0" * 11, 0)], _EOL)
    for codes, state in (([("0001", 0)], _PASS), ([("001", 0)], _HORIZ), ([("1", 0)], _V0),
                         ([("011", 1), ("000011", 2), ("0000011", 3)], _VR),
                         ([("010", 1), ("000010", 2), ("0000010", 3)], _VL),
                         ([("0000001", 0)], _EXT), ([("0000000", 0)], _EOL)):
        _fill(main, 7, codes, state)
    return white, black, main


class _Fail(Exception):
    """A strip libtiff's decoder returns -1 on."""


class _Eof(Exception):
    """NeedBits found no bit left (libtiff's goto eoflab)."""


class _Reader:
    """libtiff's bit accumulator over one strip's bytes (MSB first after
    any fill-order reversal): `end` is where the bits held end, the data's
    end until a lookup runs past it and is padded with zeros."""

    def __init__(self, data: bytes):
        self.n = 8 * len(data)
        buf = np.frombuffer(bytes(data) + bytes(4), np.uint8).astype(np.uint32)
        # 24 bits, MSB first, at each byte: any 16 bits from a bit position
        self.words = ((buf[:-2] << 16) | (buf[1:-1] << 8) | buf[2:]).tolist()
        self.p = 0
        self.end = self.n

    def need(self, n: int) -> None:
        avail = self.end - self.p
        if avail < n:
            if avail <= 0:
                raise _Eof
            self.end = self.p + n

    def get(self, n: int) -> int:
        p = self.p
        if p >= self.n:
            return 0
        return (self.words[p >> 3] >> (24 - (p & 7) - n)) & ((1 << n) - 1)

    def lookup(self, n: int, table):
        self.need(n)
        ent = table[self.get(n)]
        self.p += ent[1]
        return ent


class _Row:
    """One row's decoding state: runs written from `pa` into `cur` (a
    run array of `nruns` slots), a0, RunLength, the row's width."""

    def __init__(self, cur, nruns: int, lastx: int):
        self.cur, self.nruns, self.lastx = cur, nruns, lastx
        self.pa = 0
        self.a0 = 0
        self.run = 0

    def setvalue(self, x: int) -> None:
        if self.pa >= self.nruns:
            raise _Fail("run array overflow")
        self.cur[self.pa] = (self.run + x) & 0xFFFFFFFF
        self.pa += 1
        self.a0 += x
        self.run = 0

    def cleanup(self) -> None:
        """CLEANUP_RUNS: the row's runs made to end at its width."""
        if self.run:
            self.setvalue(0)
        lastx = self.lastx
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > 0:
                self.pa -= 1
                self.a0 -= self.cur[self.pa]
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if self.pa & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)


def _fill_row(out: np.ndarray, cur, pa: int, lastx: int) -> None:
    """_TIFFFax3fillruns: white runs 0, black runs 1, each clamped to the
    row (the array keeps the clamped values); an odd count gets a 0 run."""
    if pa & 1:
        cur[pa] = 0
        pa += 1
    x = 0
    for k in range(0, pa, 2):
        for j, bit in ((k, 0), (k + 1, 1)):
            run = cur[j]
            if x + run > lastx or run > lastx:
                run = cur[j] = (lastx - x) & 0xFFFFFFFF
            if run:
                out[x:x + run] = bit
                x += run


def _expand1d(r: _Reader, row: _Row, white, black) -> bool:
    """EXPAND1D: a row of modified-Huffman runs; True if it ended on an
    EOL. _Eof where the data ends (the caller cleans up)."""
    while True:
        for table, term, makeup in ((white, _TERMW, _MAKEUPW), (black, _TERMB, _MAKEUPB)):
            while True:
                state, _, param = r.lookup(12 if table is white else 13, table)
                if state == _EOL:
                    row.cleanup()
                    return True
                if state == term:
                    row.setvalue(param)
                    break
                if state in (makeup, _MAKEUP):
                    row.a0 += param
                    row.run += param
                    continue
                row.cleanup()  # libtiff's "unexpected": reported only
                return False
            if row.a0 >= row.lastx:
                row.cleanup()
                return False
        if row.cur[row.pa - 1] == 0 and row.cur[row.pa - 2] == 0:
            row.pa -= 2


def _sync_eol(r: _Reader, eol: bool) -> None:
    """SYNC_EOL: (unless an EOL was just read) to 11 zero bits, then past
    the zero bytes and bits to the EOL's 1, and past it."""
    if not eol:
        while True:
            r.need(11)
            if r.get(11) == 0:
                break
            r.p += 1
    while True:
        r.need(8)
        if r.get(8):
            break
        r.p += 8
    while r.get(1) == 0:
        r.p += 1
    r.p += 1


def _expand2d(r: _Reader, row: _Row, ref, white, black, main) -> bool:
    """EXPAND2D: a row coded against the reference runs `ref`; True if it
    ended on an EOL."""
    lastx, nruns = row.lastx, row.nruns
    pb = 0
    b1 = ref[pb]
    pb += 1

    def check_b1():
        nonlocal b1, pb
        if row.pa != 0:
            while b1 <= row.a0 and b1 < lastx:
                if pb + 1 >= nruns:
                    raise _Fail("reference run array overflow")
                b1 += ref[pb] + ref[pb + 1]
                pb += 2

    def runs_of(table, term, makeup, size):
        while True:
            state, _, param = r.lookup(size, table)
            if state == term:
                row.setvalue(param)
                return True
            if state in (makeup, _MAKEUP):
                row.a0 += param
                row.run += param
                continue
            return False

    while row.a0 < lastx:
        if row.pa >= nruns:
            raise _Fail("run array overflow")
        state, _, param = r.lookup(7, main)
        if state == _PASS:
            check_b1()
            if pb + 1 >= nruns:
                raise _Fail("reference run array overflow")
            b1 += ref[pb]
            pb += 1
            row.run += b1 - row.a0
            row.a0 = b1
            b1 += ref[pb]
            pb += 1
        elif state == _HORIZ:
            order = ((black, _TERMB, _MAKEUPB, 13), (white, _TERMW, _MAKEUPW, 12))
            if not row.pa & 1:
                order = order[::-1]
            if not (runs_of(*order[0]) and runs_of(*order[1])):
                break  # a bad code: reported only
            check_b1()
        elif state == _V0:
            check_b1()
            row.setvalue(b1 - row.a0)
            if pb >= nruns:
                raise _Fail("reference run array overflow")
            b1 += ref[pb]
            pb += 1
        elif state == _VR:
            check_b1()
            row.setvalue(b1 - row.a0 + param)
            if pb >= nruns:
                raise _Fail("reference run array overflow")
            b1 += ref[pb]
            pb += 1
        elif state == _VL:
            check_b1()
            if b1 < row.a0 + param:
                break  # reported only
            row.setvalue(b1 - row.a0 - param)
            pb -= 1
            b1 -= ref[pb]
        elif state == _EXT:
            row.cur[row.pa] = (lastx - row.a0) & 0xFFFFFFFF
            row.pa += 1
            break
        elif state == _EOL:
            row.cur[row.pa] = (lastx - row.a0) & 0xFFFFFFFF
            row.pa += 1
            r.need(4)
            r.p += 4
            row.cleanup()
            return True
        else:
            break  # reported only
    else:
        if row.run:
            if row.run + row.a0 < lastx:  # a final V0 is expected
                r.need(1)
                if not r.get(1):
                    row.cleanup()
                    return False
                r.p += 1
            row.setvalue(0)
    row.cleanup()
    return False


def decode_ccitt(data: bytes, kind: int, width: int, rows: int, options: int = 0) -> np.ndarray:
    """(rows, width) uint8 bits (1 where libtiff fills black runs) of one
    strip or tile of compression `kind` (2: RLE, 3: Group 3 with
    T4Options `options`, 4: Group 4)."""
    white, black, main = _tables()
    two_d = kind == 4 or (kind == 3 and options & 1)
    nruns = -(-(width + 1) // 32) * 32 * (2 if two_d else 1)
    cur, ref = [0] * (nruns + 2), [0] * (nruns + 2)
    ref[0] = width
    out = np.zeros((rows, width), np.uint8)
    r = _Reader(data)
    eol = False
    try:
        for y in range(rows):
            row = _Row(cur, nruns, width)
            try:
                if kind == 2:
                    _expand1d(r, row, white, black)
                elif kind == 3:
                    _sync_eol(r, eol)
                    if two_d:
                        r.need(1)
                        coded_1d = r.get(1)
                        r.p += 1
                        eol = (_expand1d(r, row, white, black) if coded_1d else
                               _expand2d(r, row, ref, white, black, main))
                    else:
                        eol = _expand1d(r, row, white, black)
                elif _expand2d(r, row, ref, white, black, main):
                    raise _Eof  # Group 4: an EOL (EOFB) ends the strip
            except _Eof:  # libtiff leaves the rest of the strip unwritten
                raise DecodeError(f"CCITT: premature end of data in row {y}") from None
            _fill_row(out[y], cur, row.pa, width)
            if kind == 2:  # the next row starts on a byte
                r.p += (r.end - r.p) % 8
            elif two_d:
                if kind == 4 or row.pa < nruns:
                    row.setvalue(0)  # the reference row's imaginary last change
                cur, ref = ref, cur
    except _Fail as e:
        raise DecodeError(f"CCITT: {e}") from None
    return out
