"""Which of PIL's format plugins `Image.open` settles on for a file, for
the formats after its first five (BMP, GIF, JPEG, PNM, PNG): each test
here is a plugin's accept test and, where the plugin's `_open` can fail
with one of the errors on which `Image.open` goes on to the next plugin
(SyntaxError, and IndexError, TypeError, KeyError, EOFError and
struct.error, which ImageFile turns into SyntaxError, or a mode or size
left unset), the checks it makes before those points. A plugin that takes a file and then fails on it with
another error ends PIL's search there, so such a file is that plugin's.

models/texture.decode_texture asks these in PIL's order (Image.ID). That
matters for TGA, which has no magic number: PIL tries it after every
plugin here, so a file that starts like a PCX, an icon, a cursor or a GIMP
brush but fails that plugin's checks may still be a TGA.
"""

from __future__ import annotations

import re
import struct

from .icon_decode import DecodeError, icns_resources, icns_sizes


def _u16le(d: bytes, p: int) -> int:
    return int.from_bytes(d[p:p + 2], "little")


def _u32le(d: bytes, p: int) -> int:
    return int.from_bytes(d[p:p + 4], "little")


def entries(data: bytes) -> bool:
    """A cursor's or icon's directory as CurImageFile and IcoFile read it:
    at least one 16-byte entry, each present (else PIL tries the next
    plugin)."""
    count = _u16le(data, 4)
    return count > 0 and len(data) >= 6 + 16 * count


def cur(d: bytes) -> bool:
    """CurImageFile: the magic, the directory, and a DIB header size to
    read at the chosen entry."""
    if d[:4] != b"\0\0\2\0" or not entries(d):
        return False
    best = d[6:22]
    for i in range(1, _u16le(d, 4)):
        s = d[6 + 16 * i:22 + 16 * i]
        if s[0] > best[0] and s[1] > best[1]:
            best = s
    return _u32le(best, 12) + 4 <= len(d)


def pcx(d: bytes, start: int = 0) -> bool:
    """PcxImageFile: the accept test, a full header and a box that is not
    empty."""
    h = d[start:start + 68]
    if len(h) < 68 or h[0] != 10 or h[1] not in (0, 2, 3, 5):
        return False
    return _u16le(h, 8) + 1 > _u16le(h, 4) and _u16le(h, 10) + 1 > _u16le(h, 6)


def dcx(d: bytes) -> bool:
    """DcxImageFile: the magic, the page table to its 0 entry (or 1,024
    entries), and a first page whose PCX header PIL takes."""
    if len(d) < 4 or _u32le(d, 0) != 0x3ADE68B1:
        return False
    for i in range(1024):
        if 8 + 4 * i > len(d):
            return False
        if not _u32le(d, 4 + 4 * i):
            break
    return _u32le(d, 4) != 0 and pcx(d, _u32le(d, 4))


def icns(d: bytes) -> bool:
    """IcnsFile: the magic, every block header up to the header's size, and
    one resource of a size PIL reads."""
    if d[:4] != b"icns":
        return False
    try:
        return bool(icns_sizes(icns_resources(d)))
    except DecodeError:
        return False


def msp(d: bytes) -> bool:
    """MspImageFile: the magic and a header whose 16 words XOR to 0."""
    if d[:4] not in (b"DanM", b"LinS") or len(d) < 32:
        return False
    checksum = 0
    for w in struct.unpack("<16H", d[:32]):
        checksum ^= w
    return checksum == 0


def gbr(d: bytes) -> bool:
    """GbrImageFile: the accept test and _open's checks (header size,
    version, a size not 0, depth 1 or 4, v2's GIMP magic)."""
    if len(d) < 20:
        return False
    size, version, width, height, depth = struct.unpack(">5I", d[:20])
    if size < 20 or version not in (1, 2) or not width or not height or depth not in (1, 4):
        return False
    return version == 1 or d[20:24] == b"GIMP"


def fli(d: bytes) -> bool:
    """FliImageFile's accept test."""
    return len(d) >= 16 and _u16le(d, 4) in (0xAF11, 0xAF12) and _u16le(d, 14) in (0, 3)


_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {"Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)", "Image type"}


def im(d: bytes) -> bool:
    """ImImageFile's header: a LF in the first 100 bytes, then "key: value"
    lines (each under 101 bytes) up to a NUL, 0x1A or the end, at least one
    of its keys among them, a 0x1A after them and an "Image size" of two
    numbers. A value that is not a number fails in IM itself."""
    if b"\n" not in d[:100]:
        return False
    pos, n, size = 0, 0, None
    while True:
        s = d[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = d.find(b"\n", pos)
        end = len(d) if end < 0 else end + 1
        s, pos = s + d[pos:end], end
        if len(s) > 100:
            return False
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            return False
        k = m.group(1).decode("latin-1")
        if k == "Image size (x*y)":
            size = m.group(2).decode("latin-1").replace("*", ",").split(",")
        n += k in _IM_TAGS
    if not n:
        return False
    while s and not s.startswith(b"\x1a"):
        s = d[pos:pos + 1]
        pos += len(s)
    return bool(s) and (size is None or len(size) == 2)


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def imt(d: bytes) -> bool:
    """ImtImageFile: a LF in the first 100 bytes and width, height (not 0)
    and "pixel n8" fields before the data."""
    if b"\n" not in d[:100]:
        return False
    width = height = 0
    mode = False
    for line in d.split(b"\n"):
        if not line or line[:1] == b"\x0c":
            break
        if len(line) == 1 or len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = _IMT_FIELD.match(line)
        if not m:
            break
        k, v = m.groups()
        try:
            if k == b"width":
                width = int(v)
            elif k == b"height":
                height = int(v)
        except ValueError:
            return True  # PIL fails in IMT
        mode = mode or (k == b"pixel" and v == b"n8")
    return mode and width > 0 and height > 0


def iptc(d: bytes) -> bool:
    """IptcImageFile: its fields read as PIL reads them (0x1C, a record it
    lists, a size) up to an all-zero header or tag (8, 10); then a (3, 60)
    field of two bytes or more and the size fields (3, 20) and (3, 30)
    (PIL goes on where one is missing), and a known compression (else PIL
    fails in IPTC) with a mode and a size not 0."""
    pos, info, tag = 0, {}, None
    while True:
        s = d[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\0"):
            break
        if len(s) < 4 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return False
        size = s[3]
        if size > 132:
            return True  # PIL fails in IPTC
        if size == 128:
            size = 0
        elif size > 128:
            c = d[pos:pos + size - 128]
            pos += len(c)
            size = int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")
        elif len(s) < 5:
            return False
        else:
            size = int.from_bytes(s[3:5], "big")
        tag = (s[1], s[2])
        if tag == (8, 10):
            break
        info[tag] = d[pos:pos + size] if size else None
        pos += size

    def number(key):
        return int.from_bytes((b"\0\0\0\0" + info[key])[-4:], "big")

    layers = info.get((3, 60))
    if layers is None or len(layers) < 2 or info.get((3, 20)) is None \
            or info.get((3, 30)) is None:
        return False
    if info.get((3, 120)) is None or number((3, 120)) not in (1, 5):
        return True
    known = (layers[0] == 1 and not layers[1]) or (layers[0] in (3, 4) and layers[1])
    return known and number((3, 20)) > 0 and number((3, 30)) > 0


def pcd(d: bytes) -> bool:
    """PcdImageFile: "PCD_" at byte 2048."""
    return d[2048:2052] == b"PCD_"


def _spider_header(values) -> int:
    h = (99,) + tuple(values)
    for i in (1, 2, 5, 12, 13, 22, 23):
        f = h[i]
        if f != f or f in (float("inf"), float("-inf")) or f != int(f):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    return int(h[22]) if int(h[22]) == int(h[13]) * int(h[23]) else 0


def spider(d: bytes) -> bool:
    """SpiderImageFile: 27 floats, big- or little-endian, that pass PIL's
    header test, a 2D image (iform 1), stack values it accepts."""
    if len(d) < 108:
        return False
    for order in ">", "<":
        t = struct.unpack(order + "27f", d[:108])
        if _spider_header(t):
            h = (99,) + t
            if int(h[5]) != 1:
                return False
            stack, number = int(h[24]), int(h[27])
            return (stack >= 0 and number == 0) or (stack == 0 and number > 0)
    return False
