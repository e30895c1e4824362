"""8-bit PNG writer and reader on zlib and numpy.

Takes the place of PIL's PNG I/O in the crops database (written by
pipelines/make_crops.py, read by data/crops.py) and in the training
pipeline's image dumps. The writer makes 8-bit RGB images without
interlacing; the reader takes 8-bit greyscale, RGB and RGBA images without
interlacing (RGB out, alpha dropped, as PIL's ``convert('RGB')``) and all
five row filters, so it reads the databases the JAX package wrote with
PIL, which picks a filter per row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(img: np.ndarray, filter_type: int) -> np.ndarray:
    """(H, W*3) uint8 -> (H, 1 + W*3) filtered rows, one filter for all."""
    x = img.astype(np.int16)
    prior = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    left = np.hstack([np.zeros_like(x[:, :3]), x[:, :-3]])
    upleft = np.hstack([np.zeros_like(prior[:, :3]), prior[:, :-3]])
    pred = {0: 0, 1: left, 2: prior, 3: (left + prior) // 2,
            4: _paeth(left, prior, upleft)}[filter_type]
    rows = ((x - pred) % 256).astype(np.uint8)
    head = np.full((img.shape[0], 1), filter_type, np.uint8)
    return np.hstack([head, rows])


def encode(img: np.ndarray, filter_type: int = 0, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes; every row takes `filter_type` (0-4)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    raw = _filter_rows(np.ascontiguousarray(img).reshape(h, w * 3),
                       filter_type)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: running sum per channel, mod 256
        return np.cumsum(row.reshape(-1, bpp), 0, dtype=np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return row + prior
    if ftype not in (3, 4):
        raise ValueError(f"PNG row filter {ftype} is not defined")
    # Average and Paeth depend on the decoded left neighbour: byte by byte
    out = bytearray(row.tobytes())
    up = prior.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}: only 8-bit grey, RGB and "
                         "RGBA without interlacing are read")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior,
                                       bpp)
    img = out.reshape(h, w, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())
