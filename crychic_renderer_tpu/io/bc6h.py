"""BC6H (BPTC_FLOAT) block decoder — all 14 modes, vectorized numpy.

Completes the DDS loader's BC family coverage: the reference's
DDSTextureLoader maps DXGI BC6H_UF16/SF16 ids
(/root/reference/Common/DDSTextureLoader.cpp:557-700) and uploads the
compressed blocks for the GPU sampler to decode; this renderer samples
from dense arrays, so it decodes at load time instead. BC6H carries HDR
half-float RGB, so this decoder returns float32 (the exact half values),
not uint8.

Layout notes: a 128-bit block is a 2- or 5-bit mode id, a per-mode
scatter of endpoint bits (the `_LAYOUTS` table below, stream order,
LSB-first within each listed slice), a 5-bit partition id for two-region
modes (bits 77..81), and 3-bit (two-region, from bit 82) or 4-bit
(one-region, from bit 65) palette indices with the anchor texels' MSB
dropped. Endpoints e0B/e1A/e1B are signed deltas against e0A in the
transformed modes, absolute values in modes 10/11. The layout and
arithmetic are verified per-bit against an independent decoder (Pillow's
BCn C decoder) through amplified probe blocks, and fuzz-tested against it
in tests/test_io.py.
"""
from __future__ import annotations

import numpy as np

from .bc7 import _P2, _ANCHOR2, _WEIGHTS


def _expand_layout(*slices):
    """slices: (field, hi, lo) -> [(field, sig), ...] LSB-first per slice.

    A slice with hi < lo emits bits in reverse (MSB-first) order — the
    extra base bits of modes 13/14 are stored reversed in the stream.
    """
    out = []
    for field, hi, lo in slices:
        step = 1 if hi >= lo else -1
        for sig in range(lo, hi + step, step):
            out.append((field, sig))
    return out


def _b(field, bit):
    return (field, bit, bit)


# Per-mode payload layouts (after the mode field, up to bit 77 for
# two-region modes / bit 65 for one-region modes). Mode key = the value
# of the mode field. Fields: {r,g,b}{w,x,y,z} = channel × (e0A, e0B,
# e1A, e1B).
_LAYOUTS = {
    # D3D mode 1: 10-bit base, 5.5.5 deltas (2-bit mode field)
    0: _expand_layout(
        _b("gy", 4), _b("by", 4), _b("bz", 4),
        ("rw", 9, 0), ("gw", 9, 0), ("bw", 9, 0),
        ("rx", 4, 0), _b("gz", 4), ("gy", 3, 0),
        ("gx", 4, 0), _b("bz", 0), ("gz", 3, 0),
        ("bx", 4, 0), _b("bz", 1), ("by", 3, 0),
        ("ry", 4, 0), _b("bz", 2),
        ("rz", 4, 0), _b("bz", 3),
    ),
    # D3D mode 2: 7-bit base, 6.6.6 deltas (2-bit mode field)
    1: _expand_layout(
        _b("gy", 5), _b("gz", 4), _b("gz", 5),
        ("rw", 6, 0), _b("bz", 0), _b("bz", 1), _b("by", 4),
        ("gw", 6, 0), _b("by", 5), _b("bz", 2), _b("gy", 4),
        ("bw", 6, 0), _b("bz", 3), _b("bz", 5), _b("bz", 4),
        ("rx", 5, 0), ("gy", 3, 0),
        ("gx", 5, 0), ("gz", 3, 0),
        ("bx", 5, 0), ("by", 3, 0),
        ("ry", 5, 0), ("rz", 5, 0),
    ),
    # D3D mode 3: 11-bit base, 5.4.4 deltas
    2: _expand_layout(
        ("rw", 9, 0), ("gw", 9, 0), ("bw", 9, 0),
        ("rx", 4, 0), _b("rw", 10), ("gy", 3, 0),
        ("gx", 3, 0), _b("gw", 10), _b("bz", 0), ("gz", 3, 0),
        ("bx", 3, 0), _b("bw", 10), _b("bz", 1), ("by", 3, 0),
        ("ry", 4, 0), _b("bz", 2),
        ("rz", 4, 0), _b("bz", 3),
    ),
    # D3D mode 4: 11-bit base, 4.5.4 deltas
    6: _expand_layout(
        ("rw", 9, 0), ("gw", 9, 0), ("bw", 9, 0),
        ("rx", 3, 0), _b("rw", 10), _b("gz", 4), ("gy", 3, 0),
        ("gx", 4, 0), _b("gw", 10), ("gz", 3, 0),
        ("bx", 3, 0), _b("bw", 10), _b("bz", 1), ("by", 3, 0),
        ("ry", 3, 0), _b("bz", 0), _b("bz", 2),
        ("rz", 3, 0), _b("gy", 4), _b("bz", 3),
    ),
    # D3D mode 5: 11-bit base, 4.4.5 deltas
    10: _expand_layout(
        ("rw", 9, 0), ("gw", 9, 0), ("bw", 9, 0),
        ("rx", 3, 0), _b("rw", 10), _b("by", 4), ("gy", 3, 0),
        ("gx", 3, 0), _b("gw", 10), _b("bz", 0), ("gz", 3, 0),
        ("bx", 4, 0), _b("bw", 10), ("by", 3, 0),
        ("ry", 3, 0), _b("bz", 1), _b("bz", 2),
        ("rz", 3, 0), _b("bz", 4), _b("bz", 3),
    ),
    # D3D mode 6: 9-bit base, 5.5.5 deltas
    14: _expand_layout(
        ("rw", 8, 0), _b("by", 4),
        ("gw", 8, 0), _b("gy", 4),
        ("bw", 8, 0), _b("bz", 4),
        ("rx", 4, 0), _b("gz", 4), ("gy", 3, 0),
        ("gx", 4, 0), _b("bz", 0), ("gz", 3, 0),
        ("bx", 4, 0), _b("bz", 1), ("by", 3, 0),
        ("ry", 4, 0), _b("bz", 2),
        ("rz", 4, 0), _b("bz", 3),
    ),
    # D3D mode 7: 8-bit base, 6.5.5 deltas
    18: _expand_layout(
        ("rw", 7, 0), _b("gz", 4), _b("by", 4),
        ("gw", 7, 0), _b("bz", 2), _b("gy", 4),
        ("bw", 7, 0), _b("bz", 3), _b("bz", 4),
        ("rx", 5, 0), ("gy", 3, 0),
        ("gx", 4, 0), _b("bz", 0), ("gz", 3, 0),
        ("bx", 4, 0), _b("bz", 1), ("by", 3, 0),
        ("ry", 5, 0), ("rz", 5, 0),
    ),
    # D3D mode 8: 8-bit base, 5.6.5 deltas
    22: _expand_layout(
        ("rw", 7, 0), _b("bz", 0), _b("by", 4),
        ("gw", 7, 0), _b("gy", 5), _b("gy", 4),
        ("bw", 7, 0), _b("gz", 5), _b("bz", 4),
        ("rx", 4, 0), _b("gz", 4), ("gy", 3, 0),
        ("gx", 5, 0), ("gz", 3, 0),
        ("bx", 4, 0), _b("bz", 1), ("by", 3, 0),
        ("ry", 4, 0), _b("bz", 2),
        ("rz", 4, 0), _b("bz", 3),
    ),
    # D3D mode 9: 8-bit base, 5.5.6 deltas
    26: _expand_layout(
        ("rw", 7, 0), _b("bz", 1), _b("by", 4),
        ("gw", 7, 0), _b("by", 5), _b("gy", 4),
        ("bw", 7, 0), _b("bz", 5), _b("bz", 4),
        ("rx", 4, 0), _b("gz", 4), ("gy", 3, 0),
        ("gx", 4, 0), _b("bz", 0), ("gz", 3, 0),
        ("bx", 5, 0), ("by", 3, 0),
        ("ry", 4, 0), _b("bz", 2),
        ("rz", 4, 0), _b("bz", 3),
    ),
    # D3D mode 10: 6-bit endpoints, untransformed
    30: _expand_layout(
        ("rw", 5, 0), _b("gz", 4), _b("bz", 0), _b("bz", 1), _b("by", 4),
        ("gw", 5, 0), _b("gy", 5), _b("by", 5), _b("bz", 2), _b("gy", 4),
        ("bw", 5, 0), _b("gz", 5), _b("bz", 3), _b("bz", 5), _b("bz", 4),
        ("rx", 5, 0), ("gy", 3, 0),
        ("gx", 5, 0), ("gz", 3, 0),
        ("bx", 5, 0), ("by", 3, 0),
        ("ry", 5, 0), ("rz", 5, 0),
    ),
    # D3D mode 11: one region, 10-bit endpoints, untransformed
    3: _expand_layout(
        ("rw", 9, 0), ("gw", 9, 0), ("bw", 9, 0),
        ("rx", 9, 0), ("gx", 9, 0), ("bx", 9, 0),
    ),
    # D3D mode 12: one region, 11-bit base, 9-bit delta
    7: _expand_layout(
        ("rw", 9, 0), ("gw", 9, 0), ("bw", 9, 0),
        ("rx", 8, 0), _b("rw", 10),
        ("gx", 8, 0), _b("gw", 10),
        ("bx", 8, 0), _b("bw", 10),
    ),
    # D3D mode 13: one region, 12-bit base, 8-bit delta (high base bits
    # stored MSB-first)
    11: _expand_layout(
        ("rw", 9, 0), ("gw", 9, 0), ("bw", 9, 0),
        ("rx", 7, 0), ("rw", 10, 11),
        ("gx", 7, 0), ("gw", 10, 11),
        ("bx", 7, 0), ("bw", 10, 11),
    ),
    # D3D mode 14: one region, 16-bit base, 4-bit delta (high base bits
    # stored MSB-first)
    15: _expand_layout(
        ("rw", 9, 0), ("gw", 9, 0), ("bw", 9, 0),
        ("rx", 3, 0), ("rw", 10, 15),
        ("gx", 3, 0), ("gw", 10, 15),
        ("bx", 3, 0), ("bw", 10, 15),
    ),
}

# mode value -> (epb, (dr, dg, db), transformed, two_region)
_MODE_INFO = {
    0: (10, (5, 5, 5), True, True),
    1: (7, (6, 6, 6), True, True),
    2: (11, (5, 4, 4), True, True),
    6: (11, (4, 5, 4), True, True),
    10: (11, (4, 4, 5), True, True),
    14: (9, (5, 5, 5), True, True),
    18: (8, (6, 5, 5), True, True),
    22: (8, (5, 6, 5), True, True),
    26: (8, (5, 5, 6), True, True),
    30: (6, (6, 6, 6), False, True),
    3: (10, (10, 10, 10), False, False),
    7: (11, (9, 9, 9), True, False),
    11: (12, (8, 8, 8), True, False),
    15: (16, (4, 4, 4), True, False),
}

_CHANNELS = "rgb"
_GROUPS = ("w", "x", "y", "z")


def _sext(v, bits):
    """Sign-extend the low `bits` of v (int64 array)."""
    sign = np.int64(1) << (bits - 1)
    return (v ^ sign) - sign


def _unquantize_unsigned(v, epb):
    """D3D BC6H unsigned unquantize: epb-bit value -> 17-bit workspace."""
    if epb >= 15:
        return v
    maxv = (1 << epb) - 1
    gen = ((v << 16) + 0x8000) >> epb
    return np.where(v == 0, 0, np.where(v == maxv, 0xFFFF, gen))


def _unquantize_signed(v, epb):
    if epb >= 16:
        return v
    s = v < 0
    x = np.abs(v)
    maxv = (1 << (epb - 1)) - 1
    gen = ((x << 15) + 0x4000) >> (epb - 1)
    unq = np.where(x == 0, 0, np.where(x >= maxv, 0x7FFF, gen))
    return np.where(s, -unq, unq)


def _finish_unsigned(v):
    return ((v * 31) >> 6).astype(np.uint16)


def _finish_signed(v):
    mag = (np.abs(v) * 31) >> 5
    return np.where(v < 0, 0x8000 | mag, mag).astype(np.uint16)


def _unpack_indices(bits, base, ib, anchors):
    """Per-texel palette indices with anchor-MSB truncation.

    bits (M,128); base: stream start bit; anchors: list of (M,) anchor
    texel ids (their index is ib-1 bits wide). Returns (M,16) int64.
    """
    m = bits.shape[0]
    widths = np.full((m, 16), ib, dtype=np.int64)
    cols = np.arange(16)[None, :]
    for a in anchors:
        widths[cols == a[:, None]] -= 1
    offsets = np.zeros((m, 16), dtype=np.int64)
    offsets[:, 1:] = np.cumsum(widths[:, :-1], axis=1)
    rows = np.arange(m)[:, None]
    idx = np.zeros((m, 16), dtype=np.int64)
    for k in range(ib):
        valid = k < widths
        pos = np.minimum(base + offsets + k, 127)
        bit = bits[rows, pos].astype(np.int64)
        idx |= np.where(valid, bit, 0) << k
    return idx


def _decode_mode(bits, mode_value, signed, pillow_emulation=False):
    """Decode all blocks of one mode. bits (M,128) -> (M,16,3) uint16
    half-float bit patterns.

    pillow_emulation replicates two spec deviations of Pillow's BCn
    decoder (found by per-bit probing against it) so the
    verification harness can require EXACT agreement: Pillow skips the
    +32 rounding term of the palette interpolation, and in SF16
    transformed modes it adds the delta to the raw (non-sign-extended)
    base without wrapping to the endpoint precision. The shipped decode
    path (default) follows the D3D functional spec.
    """
    m = bits.shape[0]
    epb, deltas, transformed, two_region = _MODE_INFO[mode_value]
    mode_len = 2 if mode_value in (0, 1) else 5
    layout = _LAYOUTS[mode_value]

    fields = {}
    for pos, (field, sig) in enumerate(layout, start=mode_len):
        cur = fields.get(field)
        if cur is None:
            cur = np.zeros(m, dtype=np.int64)
            fields[field] = cur
        cur |= bits[:, pos].astype(np.int64) << sig

    groups = _GROUPS if two_region else ("w", "x")
    # raw endpoint integers per channel/group
    ep = np.zeros((m, 3, len(groups)), dtype=np.int64)
    for ci, ch in enumerate(_CHANNELS):
        mask = (1 << epb) - 1
        raw_base = fields.get(ch + "w", np.zeros(m, dtype=np.int64))
        base = _sext(raw_base, epb) if signed else raw_base
        ep[:, ci, 0] = base
        for gi, g in enumerate(groups[1:], start=1):
            raw = fields.get(ch + g, np.zeros(m, dtype=np.int64))
            dw = deltas[ci]
            if transformed:
                val = (base + _sext(raw, dw)) & mask
                if signed:
                    if not pillow_emulation:
                        val = _sext(val, epb)
                    elif epb >= 16:
                        # Pillow's C decoder forgets to re-sign-extend
                        # the wrapped sum at the endpoint precision; its
                        # int16 storage still truncates the 16-bit mode.
                        val = _sext(val, 16)
            else:
                val = _sext(raw, dw) if signed else raw
            ep[:, ci, gi] = val

    unq = _unquantize_signed(ep, epb) if signed else _unquantize_unsigned(
        ep, epb)

    if two_region:
        d = np.zeros(m, dtype=np.int64)
        for k in range(5):
            d |= bits[:, 77 + k].astype(np.int64) << k
        subset = _P2[d]  # (M, 16)
        anchors = [np.zeros(m, dtype=np.int64), _ANCHOR2[d]]
        idx = _unpack_indices(bits, 82, 3, anchors)
        w = _WEIGHTS[3][idx]  # (M, 16)
    else:
        subset = np.zeros((m, 16), dtype=np.int64)
        idx = _unpack_indices(bits, 65, 4, [np.zeros(m, dtype=np.int64)])
        w = _WEIGHTS[4][idx]

    # pick endpoints per texel: A = group 2*subset, B = group 2*subset+1
    rows3 = np.arange(m)[:, None, None]
    ch3 = np.arange(3)[None, None, :]
    ga = (2 * subset)[:, :, None]
    a = unq.transpose(0, 2, 1)[rows3, ga, ch3]        # (M,16,3)
    b = unq.transpose(0, 2, 1)[rows3, ga + 1, ch3]
    rnd = 0 if pillow_emulation else 32
    interp = (a * (64 - w[..., None]) + b * w[..., None] + rnd) >> 6
    return _finish_signed(interp) if signed else _finish_unsigned(interp)


def decode_bc6h_blocks(raw: np.ndarray, signed: bool,
                       pillow_emulation: bool = False) -> np.ndarray:
    """(N,16) uint8 BC6H blocks -> (N,16,3) uint16 half bit patterns."""
    n = raw.shape[0]
    bits = np.unpackbits(raw, axis=1, bitorder="little")  # (N,128)
    low2 = bits[:, 0].astype(np.int64) | (bits[:, 1].astype(np.int64) << 1)
    low5 = low2.copy()
    for k in (2, 3, 4):
        low5 |= bits[:, k].astype(np.int64) << k
    mode = np.where(low2 < 2, low2, low5)
    out = np.zeros((n, 16, 3), dtype=np.uint16)  # reserved modes -> 0
    for mv in _MODE_INFO:
        sel = np.nonzero(mode == mv)[0]
        if sel.size:
            out[sel] = _decode_mode(bits[sel], mv, signed, pillow_emulation)
    return out


def decode_bc6h(data: bytes, width: int, height: int,
                signed: bool = False,
                pillow_emulation: bool = False) -> np.ndarray:
    """BC6H_UF16/SF16: 16-byte HDR blocks. Returns (H, W, 3) float32."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    raw = np.frombuffer(data, dtype=np.uint8, count=n * 16).reshape(n, 16)
    texels = decode_bc6h_blocks(raw, signed,
                                pillow_emulation)  # (N,16,3) u16 half bits
    img = texels.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4)
    img = np.ascontiguousarray(img.reshape(bh * 4, bw * 4, 3)[:height, :width])
    return img.view(np.float16).astype(np.float32)
