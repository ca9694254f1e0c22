"""A PNG codec in ``zlib`` and numpy, and the image reader of the loaders.

The JAX package decodes its images with PIL (``egonerf_tpu/data/
datasets.py:44-56``) and writes its synthesised captures with ``imageio``;
the port reads and writes PNG with this module on every machine, so the
card and the host turn the same bytes into the same arrays.

* :func:`decode` reads 8-bit grey, RGB and RGBA, non-interlaced, with any
  of the five filter types (None, Sub, Up, Average, Paeth) on any row.
  Every other kind (another bit depth, a palette, grey with alpha, Adam7
  interlacing) raises :class:`PNGError` naming the kind.  Chunk CRCs are
  checked.
* :func:`encode` writes 8-bit RGB with one filter type on every row.
* :func:`read_image` decodes a PNG file with :func:`decode` and hands any
  other format (OmniScenes' ``.jpg``, what an LLFF folder holds) to PIL,
  imported at use; without PIL that is an error naming the format.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the kinds the codec reads
_CHANNELS = {0: 1, 2: 3, 6: 4}
_KINDS = {3: "palette (colour type 3)", 4: "grey with alpha (colour type 4)"}
_FILTERS = (0, 1, 2, 3, 4)
# leading bytes of the formats a loader may meet besides PNG
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "WebP"))


class PNGError(ValueError):
    """A PNG the codec does not read, or a damaged one."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise PNGError("truncated chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"CRC mismatch in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PNGError("no IEND chunk")


def _unfilter_rows(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """(h, stride) reconstructed bytes of rows filtered by None, Sub or Up
    only: one vectorised step a row, each row from the one above."""
    out = np.empty_like(rows)
    prev = np.zeros(rows.shape[1], np.uint8)
    for r, kind in enumerate(kinds.tolist()):
        if kind == 0:
            out[r] = rows[r]
        elif kind == 1:  # Sub: a running sum of each byte position mod 256
            out[r] = np.cumsum(rows[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # Up
            out[r] = rows[r] + prev
        prev = out[r]
    return out


def _unfilter_wavefront(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """(h, stride) reconstructed bytes of rows under any of the five filters.

    A pixel depends on its left, upper and upper-left neighbours once they
    are reconstructed, so every pixel of an anti-diagonal (row + column
    constant) is reconstructed in one vectorised step: h + w - 1 steps.  The
    pixels are held skewed, pixel (r, x) at [r + x + 2, r + 1], so that a
    diagonal and each of its neighbours' diagonals is a contiguous slice;
    the two leading diagonals and the leading row stay zero, the bytes
    outside the image."""
    h, stride = rows.shape
    w = stride // bpp
    r, x = np.arange(h)[:, None], np.arange(w)[None, :]
    grid = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    raw = np.zeros_like(grid)
    raw[r + x + 2, r + 1] = rows.reshape(h, w, bpp)
    kind = np.concatenate([[0], kinds])[:, None]
    none, sub, up, avg = (kind == k for k in range(4))
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d)
        cur, above = slice(r0 + 1, r1 + 2), slice(r0, r1 + 1)
        a, b, c = grid[d + 1, cur], grid[d + 1, above], grid[d, above]
        bc, ac = b - c, a - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))   # Paeth
        np.copyto(pred, (a + b) >> 1, where=avg[cur])
        np.copyto(pred, b, where=up[cur])
        np.copyto(pred, a, where=sub[cur])
        np.copyto(pred, 0, where=none[cur])
        grid[d + 2, cur] = (raw[d + 2, cur] + pred) & 255
    return grid[r + x + 2, r + 1].astype(np.uint8).reshape(h, stride)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (h, w) for grey, (h, w, 3) RGB or (h, w, 4) RGBA."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if colour in _KINDS:
        raise PNGError(f"{_KINDS[colour]} PNG is not supported (8-bit grey, RGB, RGBA only)")
    if colour not in _CHANNELS:
        raise PNGError(f"colour type {colour} is not a PNG colour type")
    if depth != 8:
        raise PNGError(f"{depth}-bit PNG is not supported (8-bit grey, RGB, RGBA only)")
    if interlace == 1:
        raise PNGError("Adam7-interlaced PNG is not supported")
    if compression != 0 or filtering != 0 or interlace != 0:
        raise PNGError(f"unknown compression {compression}, filter method {filtering} or "
                       f"interlace method {interlace}")
    c = _CHANNELS[colour]
    stride = w * c
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise PNGError(f"image data holds {len(raw)} bytes, a {w}x{h} {c}-channel image "
                       f"needs {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    kinds = rows[:, 0]
    if h and kinds.max() > 4:
        raise PNGError(f"unknown filter type {int(kinds.max())}")
    # Average and Paeth read the byte just reconstructed to their left
    unfilter = _unfilter_wavefront if h and kinds.max() >= 3 else _unfilter_rows
    out = unfilter(rows[:, 1:], kinds, c)
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def _filter(img: np.ndarray, kind: int) -> np.ndarray:
    """(h, w*bpp) uint8 rows -> their filtered bytes under filter ``kind``."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    else:
        c = np.zeros_like(x)
        c[1:, 3:] = x[:-1, :-3]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def encode(img: np.ndarray, filter_type: int = 1) -> bytes:
    """uint8 (h, w, 3) RGB -> PNG bytes, every row under ``filter_type``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), deflated at zlib's default
    level."""
    if filter_type not in _FILTERS:
        raise ValueError(f"filter_type must be one of {_FILTERS}, got {filter_type}")
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a uint8 (h, w, 3) image, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    rows = _filter(np.ascontiguousarray(img).reshape(h, w * 3), filter_type)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, filter_type: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode(img, filter_type))


def _format_of(head: bytes, path) -> str:
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    return f"unrecognised ({str(path).rsplit('.', 1)[-1]!r} extension)"


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def read_image(path, resize_wh=None) -> np.ndarray:
    """uint8 (h, w) or (h, w, c) pixels of an image file: PNG through
    :func:`decode`, any other format through PIL.  With ``resize_wh``
    (w, h) an image of another size is resized by PIL's LANCZOS filter, as
    the JAX loaders resize.  Without PIL a non-PNG file or a resize is an
    error that names the format."""
    with open(path, "rb") as f:
        data = f.read()
    is_png = data[:8] == SIGNATURE
    arr = decode(data) if is_png else None
    size = None if arr is None else (arr.shape[1], arr.shape[0])
    if arr is not None and (resize_wh is None or size == tuple(resize_wh)):
        return arr
    image = _pil()
    if image is None:
        what = (f"resizing the PNG {path} from {size} to {tuple(resize_wh)}" if is_png
                else f"decoding {path}, a {_format_of(data[:8], path)} image")
        raise RuntimeError(f"{what} needs PIL, which is not installed; the port decodes "
                           "only PNG itself")
    img = image.fromarray(arr) if is_png else image.open(path)
    if resize_wh is not None and img.size != tuple(resize_wh):
        img = img.resize(tuple(resize_wh), image.LANCZOS)
    return np.asarray(img, dtype=np.uint8)
