"""Which of PIL's format plugins `Image.open` settles on for a file, for
the formats after its first five (BMP, GIF, JPEG, PNM, PNG): each test
here is a plugin's accept test and, where the plugin's `_open` can fail
with one of the errors on which `Image.open` goes on to the next plugin
(SyntaxError, and IndexError, TypeError, KeyError, EOFError and
struct.error, which ImageFile turns into SyntaxError, or a mode or size
left unset), the checks it makes before those points. A plugin that takes a file and then fails on it with
another error ends PIL's search there, so such a file is that plugin's.

For the formats decoded since the last plugin formats were ported (FLI/FLC,
GBR, IM, IMT, IPTC, McIdas, PCD, PIXAR, SPIDER, XVThumb) the checks are
their decoders' own `open_*` functions, which follow each plugin's `_open`.

models/texture.decode_texture asks these in PIL's order (Image.ID). That
matters for TGA, which has no magic number: PIL tries it after every
plugin here, so a file that starts like a PCX, an icon, a cursor or a GIMP
brush but fails that plugin's checks may still be a TGA.
"""

from __future__ import annotations

import struct

from . import misc_raster
from .fli_decode import open_fli
from .icon_decode import icns_resources, icns_sizes
from .im_decode import open_im, open_imt
from .image_decode import DecodeError, Unidentified
from .pcd_decode import open_pcd


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


def _takes(opener, d: bytes) -> bool:
    """Whether the plugin whose `_open` the decoder's `opener` follows takes
    the file: it opens, or fails with an error on which Image.open stops
    (Unidentified: PIL tries its next plugin)."""
    try:
        opener(d)
    except Unidentified:
        return False
    except DecodeError:  # the plugin takes the file, then fails on it
        pass
    return True


def gbr(d: bytes) -> bool:
    """GbrImageFile (utils/misc_raster.open_gbr)."""
    return _takes(misc_raster.open_gbr, d)


def fli(d: bytes) -> bool:
    """FliImageFile (utils/fli_decode.open_fli): the accept test, then
    _open's header, prefix and palette reads."""
    return _takes(open_fli, d)


def im(d: bytes) -> bool:
    """ImImageFile (utils/im_decode.open_im): a LF in the first 100 bytes,
    "key: value" lines up to a NUL, 0x1A or the end, one of PIL's keys among
    them, a 0x1A after them, a Lut read, a size and a mode."""
    return _takes(open_im, d)


def imt(d: bytes) -> bool:
    """ImtImageFile (utils/im_decode.open_imt): width, height (not 0) and
    "pixel n8" fields before the data."""
    return _takes(open_imt, d)


def iptc(d: bytes) -> bool:
    """IptcImageFile (utils/misc_raster.open_iptc): its fields up to an
    all-zero header or tag (8, 10), then the bands, size and compression
    fields as PIL reads them."""
    return _takes(misc_raster.open_iptc, d)


def mcidas(d: bytes) -> bool:
    """McIdasImageFile (utils/misc_raster.open_mcidas)."""
    return d[:8] == b"\0\0\0\0\0\0\0\4" and _takes(misc_raster.open_mcidas, d)


def pcd(d: bytes) -> bool:
    """PcdImageFile (utils/pcd_decode.open_pcd): "PCD_" at byte 2048 and the
    orientation byte."""
    return _takes(open_pcd, d)


def pixar(d: bytes) -> bool:
    """PixarImageFile (utils/misc_raster.open_pixar): the magic, then mode
    (14, 2) (another leaves PIL's mode unset) and a size."""
    return d[:4] == b"\x80\xe8\0\0" and _takes(misc_raster.open_pixar, d)


def spider(d: bytes) -> bool:
    """SpiderImageFile (utils/misc_raster.open_spider): 27 floats, big- or
    little-endian, that pass PIL's header test, a 2D image (iform 1), stack
    values it accepts, a size."""
    return _takes(misc_raster.open_spider, d)


def xvthumb(d: bytes) -> bool:
    """XVThumbImageFile (utils/misc_raster.open_xvthumb): "P7 332", the
    header lines, a size."""
    return d[:6] == b"P7 332" and _takes(misc_raster.open_xvthumb, d)
