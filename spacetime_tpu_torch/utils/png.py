"""PNG reading and writing on `zlib` and `struct` alone (no pillow).

`read_png` decodes what `scene.image_to_softbody` imports: 8-bit,
non-interlaced PNGs of colour types 0 (gray), 2 (RGB), 3 (palette, with
its PLTE and an optional tRNS), 4 (gray + alpha) and 6 (RGBA), any number
of IDAT chunks and all five scanline filters.  The result is (H, W, 3)
uint8, as pillow's `convert("RGB")` gives it: gray replicated to three
channels, alpha (and a palette's tRNS) dropped.  Interlaced images and bit
depths other than 8 raise ValueError naming what is not supported.

`encode_png` / `write_png` write (H, W, 3) uint8 frames as 8-bit RGB with
filter 0 on every row (what the frame sinks and `Engine.save_png` use).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} has a bad CRC")
        yield kind, payload
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG (no IEND chunk)")


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The (height, stride) bytes of the image from the filtered scanlines."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum per byte of the pixel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64) & 0xFF
                   ).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:  # Average (left to right: each byte reads its left neighbour)
            buf = bytearray(line.tobytes())
            _average_row(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(buf, np.uint8)
        elif ftype == 4:  # Paeth
            buf = bytearray(line.tobytes())
            _paeth_row(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(buf, np.uint8)
        else:
            raise ValueError(f"PNG scanline {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of PNG bytes (see the module docstring)."""
    header, idat, palette = None, [], None
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not a valid colour type")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (8-bit images only)")
    if interlace != 0:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression {comp} / filter method {filt} is not supported")
    channels = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width * channels, channels)
    px = px.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        table = np.zeros((256, 3), np.uint8)  # indices past the palette read black
        table[:len(palette)] = palette
        return table[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 of the PNG file at `path`."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(rgb: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 array: 8-bit RGB, filter 0 rows."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, not {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # a leading 0: filter type None
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array to `path` as PNG."""
    data = encode_png(rgb)
    with open(path, "wb") as f:
        f.write(data)
