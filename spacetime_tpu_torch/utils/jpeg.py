"""Baseline JPEG encoder in numpy (the live view's Python path, no pillow).

`encode_jpeg(rgb, quality)` writes an (H, W, 3) uint8 frame as a baseline
sequential JFIF: YCbCr 4:4:4 (the JFIF conversion), the orthonormal 8x8
DCT as one (64, 64) matrix product per block, the standard quantization tables of
ITU-T T.81 Annex K.1-K.2 scaled by `quality` as libjpeg scales them, and
the standard Huffman tables of Annex K.3-K.6.  Every step is vectorized
over the blocks: the entropy coder forms one (code, length) event per DC
difference, per nonzero AC coefficient (with its zero-run and ZRL codes)
and per end of block, orders them, and packs their bits with numpy, then
stuffs a 0x00 after every 0xFF byte of the scan.
"""

from __future__ import annotations

import struct

import numpy as np

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.3-K.6: code counts by length 1..16, then the symbols
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _dct2_zigzag() -> np.ndarray:
    """The orthonormal 8x8 2D DCT as a (64, 64) matrix on a block's
    row-major pixels, its rows in zigzag order."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    a = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    a[0] /= np.sqrt(2.0)
    return np.kron(a, a)[ZIGZAG].astype(np.float32)


_DCT2_ZIGZAG = _dct2_zigzag()


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """`base` scaled to `quality` (1-100) as libjpeg scales it, within 1..255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _codes(spec):
    """(code, length) tables indexed by symbol (0..255) of a Huffman spec."""
    counts, symbols = spec
    code_of = np.zeros(256, np.uint64)
    len_of = np.zeros(256, np.int64)
    code, i = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[i]] = code
            len_of[symbols[i]] = length
            code += 1
            i += 1
        code <<= 1
    return code_of, len_of


_TABLES = [(_codes(_DC_LUMA), _codes(_AC_LUMA)), (_codes(_DC_CHROMA), _codes(_AC_CHROMA))]


def _size(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (the JPEG magnitude category)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The `size` low bits that code v (negative v as v - 1 in one's complement)."""
    return np.where(v < 0, v + (1 << size) - 1, v).astype(np.uint64)


def _blocks(rgb: np.ndarray, qtabs) -> np.ndarray:
    """Quantized zigzag coefficients, (MCUs, 3 components, 64) int64."""
    h, w, _ = rgb.shape
    ph, pw = -h % 8, -w % 8
    x = np.pad(rgb, ((0, ph), (0, pw), (0, 0)), mode="edge").astype(np.float32)
    to_ycc = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], np.float32)
    ycc = x @ to_ycc.T - np.array([128.0, 0.0, 0.0], np.float32)  # level-shifted
    hb, wb = ycc.shape[0] // 8, ycc.shape[1] // 8
    # each block's 64 pixels in row-major order, times the 2D DCT's rows
    blk = ycc.reshape(hb, 8, wb, 8, 3).transpose(0, 2, 4, 1, 3).reshape(-1, 64)
    coef = (blk @ _DCT2_ZIGZAG.T).reshape(hb * wb, 3, 64)
    q = np.stack([qtabs[0], qtabs[1], qtabs[1]])[:, ZIGZAG].astype(np.float32)
    return np.rint(coef / q).astype(np.int64)


def _scan(zz: np.ndarray) -> bytes:
    """The entropy-coded scan of `zz` (MCUs, 3, 64), bytes stuffed."""
    n = zz.shape[0]
    comp = np.tile(np.arange(3), n)  # component of each block, in scan order
    table = np.minimum(comp, 1)  # luma tables for Y, chroma for Cb and Cr
    flat = zz.reshape(n * 3, 64)
    keys, codes, lens = [], [], []
    # DC: the difference from the same component's previous block
    dc = zz[:, :, 0]
    diff = np.diff(dc, axis=0, prepend=0).reshape(-1)
    size = _size(diff)
    for t in (0, 1):
        sel = table == t
        (dc_code, dc_len), _ = _TABLES[t]
        s = size[sel]
        codes.append((dc_code[s] << s.astype(np.uint64)) | _bits(diff[sel], s))
        lens.append(dc_len[s] + s)
        keys.append(np.nonzero(sel)[0] * 65)
    # AC: each nonzero coefficient with its zero-run (ZRL codes for runs of 16)
    blk, k = np.nonzero(flat[:, 1:])
    k = k + 1
    first = np.ones(len(k), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    v = flat[blk, k]
    size = _size(v)
    sym = ((run % 16) << 4) | size
    for t in (0, 1):
        sel = table[blk] == t
        _, (ac_code, ac_len) = _TABLES[t]
        zrl_code, zrl_len = ac_code[0xF0], ac_len[0xF0]
        nz, s = run[sel] // 16, size[sel]
        code = np.zeros(int(sel.sum()), np.uint64)
        length = np.zeros(int(sel.sum()), np.int64)
        for j in range(3):  # a run of up to 62 zeros takes at most 3 ZRLs
            z = nz > j
            code = np.where(z, (code << np.uint64(zrl_len)) | zrl_code, code)
            length = length + z * zrl_len
        code = (code << ac_len[sym[sel]].astype(np.uint64)) | ac_code[sym[sel]]
        code = (code << s.astype(np.uint64)) | _bits(v[sel], s)
        codes.append(code)
        lens.append(length + ac_len[sym[sel]] + s)
        keys.append(blk[sel] * 65 + k[sel])
    # EOB after the last nonzero coefficient of every block that ends in zeros
    last = np.where(flat[:, 1:] != 0, np.arange(1, 64), 0).max(axis=1)
    for t in (0, 1):
        sel = (last < 63) & (table == t)
        _, (ac_code, ac_len) = _TABLES[t]
        codes.append(np.full(int(sel.sum()), ac_code[0], np.uint64))
        lens.append(np.full(int(sel.sum()), ac_len[0], np.int64))
        keys.append(np.nonzero(sel)[0] * 65 + 64)
    order = np.argsort(np.concatenate(keys), kind="stable")
    code = np.concatenate(codes)[order]
    length = np.concatenate(lens)[order]
    # pack: bit j of event e is bit (length - 1 - j) of its code
    total = int(length.sum())
    ev = np.repeat(np.arange(len(code)), length)
    start = np.cumsum(length) - length
    j = np.arange(total) - start[ev]
    bits = ((code[ev] >> (length[ev] - 1 - j).astype(np.uint64)) & np.uint64(1)).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])  # pad with 1 bits
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def encode_jpeg(rgb: np.ndarray, quality: int = 85) -> bytes:
    """Baseline JFIF bytes of an (H, W, 3) uint8 frame at `quality`."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, not {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    qtabs = (quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality))
    dqt = b"".join(bytes([i]) + bytes(q[ZIGZAG].astype(np.uint8)) for i, q in enumerate(qtabs))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b""
    for tc_th, (counts, symbols) in ((0x00, _DC_LUMA), (0x10, _AC_LUMA),
                                    (0x01, _DC_CHROMA), (0x11, _AC_CHROMA)):
        dht += bytes([tc_th, *counts, *symbols])
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _segment(0xFFDB, dqt) + _segment(0xFFC0, sof) + _segment(0xFFC4, dht)
            + _segment(0xFFDA, sos) + _scan(_blocks(rgb, qtabs)) + b"\xff\xd9")
