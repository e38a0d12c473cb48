"""PNG reading and writing on `zlib` and `struct` alone (no pillow).

`read_png` decodes what `scene.image_to_softbody` imports: PNGs of every
legal colour type and bit depth — 0 (gray: 1, 2, 4, 8, 16), 2 (RGB: 8,
16), 3 (palette: 1, 2, 4, 8, with its PLTE and an optional tRNS), 4 (gray +
alpha: 8, 16) and 6 (RGBA: 8, 16) — plain or Adam7-interlaced, any number
of IDAT chunks and all five scanline filters.  The result is (H, W, 3)
uint8, as pillow's `convert("RGB")` gives it:

  * gray replicated to three channels; 1-, 2- and 4-bit gray scaled to
    0..255 (x 255, 85, 17); 16-bit gray clipped to 255 (pillow reads it
    as mode I;16, whose RGB conversion clips);
  * 16-bit RGB, RGBA and gray + alpha reduced to their high bytes;
  * sub-byte samples unpacked most significant bit first, each scanline
    padded to a whole byte;
  * alpha (and a palette's tRNS) dropped.

`encode_png` / `write_png` write (H, W, 3) uint8 frames as 8-bit RGB with
filter 0 on every row (what the frame sinks and `Engine.save_png` use).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the bit depths the PNG specification allows for each colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


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
    """The (height, stride) bytes of one (sub)image from its filtered
    scanlines, which `raw` starts with."""
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


def _samples(raw: bytes, width: int, height: int, depth: int, channels: int):
    """((height, width, channels) samples of one (sub)image, as uint16 for
    16-bit images and uint8 otherwise; the bytes it took from `raw`)."""
    if width == 0 or height == 0:
        return np.zeros((height, width, channels), np.uint8), 0
    bits = width * channels * depth
    stride = (bits + 7) // 8
    rows = _unfilter(raw, height, stride, max(1, channels * depth // 8))
    if depth == 16:
        px = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        px = rows
    else:
        # MSB first: sample s of a row is bits [s * depth, (s + 1) * depth)
        b = np.unpackbits(rows, axis=1)[:, :bits].reshape(height, -1, depth)
        px = np.zeros(b.shape[:2], np.uint8)
        for k in range(depth):
            px = (px << 1) | b[:, :, k]
    return px.reshape(height, width, channels), height * (stride + 1)


def _deinterlace(raw: bytes, width: int, height: int, depth: int, channels: int):
    """The full image's samples from the seven Adam7 passes, each a
    filtered subimage of its own (an empty pass has no bytes)."""
    dtype = np.uint16 if depth == 16 else np.uint8
    out = np.zeros((height, width, channels), dtype)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = max(0, (width - x0 + dx - 1) // dx)
        ph = max(0, (height - y0 + dy - 1) // dy)
        px, used = _samples(raw[pos:], pw, ph, depth, channels)
        out[y0::dy, x0::dx] = px
        pos += used
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
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG bit depth {depth} is not valid for colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is not a valid method")
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression {comp} / filter method {filt} is not supported")
    channels = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        px = _deinterlace(raw, width, height, depth, channels)
    else:
        px = _samples(raw, width, height, depth, channels)[0]
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        table = np.zeros((256, 3), np.uint8)  # indices past the palette read black
        table[:len(palette)] = palette
        return table[px[..., 0]]
    if depth == 16:
        # gray clips (pillow's I;16 to RGB); the other types keep the high byte
        px = np.minimum(px, 255) if ctype == 0 else px >> 8
        px = px.astype(np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))  # gray 1/2/4 to 0..255
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
