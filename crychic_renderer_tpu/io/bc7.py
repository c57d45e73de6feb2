"""BC7 (BPTC) block decoder — all 8 modes, vectorized numpy.

Completes the DDS loader's format coverage to the full BC1-BC7 family of
the reference's DDSTextureLoader (which maps DX10 BC7 ids at
/root/reference/Common/DDSTextureLoader.cpp:557-700 and uploads the
compressed blocks for the GPU's sampler to decode — this renderer samples
from dense arrays and decodes to RGBA8 at load time instead).

The partition and anchor tables below are public constants of the BC7
spec; they were recovered programmatically from an independent
battle-tested decoder (Pillow's BCn C decoder) rather than transcribed by
hand, and the full decoder is
fuzz-verified bit-exact against that decoder over random blocks of every
mode (tests/test_io.py).
"""
from __future__ import annotations

import numpy as np

# 2-subset partition map: P2[partition][texel] -> subset id (0/1).
_P2 = np.array([
    (0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1),
    (0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1),
    (0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1),
    (0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1),
    (0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1),
    (0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1),
    (0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1),
    (0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1),
    (0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1),
    (0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1),
    (0, 1, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0),
    (0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0),
    (0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0),
    (0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0),
    (0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1),
    (0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0),
    (0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0),
    (0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0),
    (0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 0),
    (0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0),
    (0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0),
    (0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0),
    (0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0),
    (0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1),
    (0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1),
    (0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0),
    (0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0),
    (0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0),
    (0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0),
    (0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1),
    (0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 1),
    (0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 0),
    (0, 0, 0, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0),
    (0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0),
    (0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 0),
    (0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0),
    (0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1),
    (0, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1),
    (0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0),
    (0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0),
    (0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0),
    (0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0),
    (0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0),
    (0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1),
    (0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1),
    (0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0),
    (0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0),
    (0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1),
    (0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1),
    (0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1),
    (0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1),
    (0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1),
    (0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0),
    (0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0),
    (0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1),
], dtype=np.int64)

# 3-subset partition map: P3[partition][texel] -> subset id (0/1/2).
_P3 = np.array([
    (0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 1, 2, 2, 2, 2),
    (0, 0, 0, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 2, 1),
    (0, 0, 0, 0, 2, 0, 0, 1, 2, 2, 1, 1, 2, 2, 1, 1),
    (0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 1, 0, 1, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2),
    (0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 2, 2),
    (0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1),
    (0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1),
    (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2),
    (0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2),
    (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2),
    (0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2),
    (0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2),
    (0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2),
    (0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2, 1, 2, 2, 2),
    (0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0, 2, 2, 2, 0),
    (0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2),
    (0, 1, 1, 1, 0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0),
    (0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2),
    (0, 0, 2, 2, 0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1),
    (0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2, 0, 2, 2, 2),
    (0, 0, 0, 1, 0, 0, 0, 1, 2, 2, 2, 1, 2, 2, 2, 1),
    (0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2),
    (0, 0, 0, 0, 1, 1, 0, 0, 2, 2, 1, 0, 2, 2, 1, 0),
    (0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1, 0, 0, 0, 0),
    (0, 0, 1, 2, 0, 0, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2),
    (0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1, 0, 1, 1, 0),
    (0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1),
    (0, 0, 2, 2, 1, 1, 0, 2, 1, 1, 0, 2, 0, 0, 2, 2),
    (0, 1, 1, 0, 0, 1, 1, 0, 2, 0, 0, 2, 2, 2, 2, 2),
    (0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1),
    (0, 0, 0, 0, 2, 0, 0, 0, 2, 2, 1, 1, 2, 2, 2, 1),
    (0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 2, 2, 2),
    (0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 2, 0, 0, 1, 1),
    (0, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 2, 0, 2, 2, 2),
    (0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0),
    (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0),
    (0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0),
    (0, 1, 2, 0, 2, 0, 1, 2, 1, 2, 0, 1, 0, 1, 2, 0),
    (0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2, 2, 0, 0, 1, 1),
    (0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0, 1, 1),
    (0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2),
    (0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1),
    (0, 0, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2, 1, 1, 2, 2),
    (0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 1, 1),
    (0, 2, 2, 0, 1, 2, 2, 1, 0, 2, 2, 0, 1, 2, 2, 1),
    (0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 0, 1, 0, 1),
    (0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1),
    (0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2),
    (0, 2, 2, 2, 0, 1, 1, 1, 0, 2, 2, 2, 0, 1, 1, 1),
    (0, 0, 0, 2, 1, 1, 1, 2, 0, 0, 0, 2, 1, 1, 1, 2),
    (0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2),
    (0, 2, 2, 2, 0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2),
    (0, 0, 0, 2, 1, 1, 1, 2, 1, 1, 1, 2, 0, 0, 0, 2),
    (0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2),
    (0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2),
    (0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2, 2, 2, 2, 2),
    (0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2),
    (0, 0, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2),
    (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2),
    (0, 0, 0, 2, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 1),
    (0, 2, 2, 2, 1, 2, 2, 2, 0, 2, 2, 2, 1, 2, 2, 2),
    (0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2),
    (0, 1, 1, 1, 2, 0, 1, 1, 2, 2, 0, 1, 2, 2, 2, 0),
], dtype=np.int64)

# Anchor (fix-up) texel of subset 1 for 2-subset partitions, and of
# subsets 1 / 2 for 3-subset partitions (subset 0's anchor is texel 0).
_ANCHOR2 = np.array([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
], dtype=np.int64)
_ANCHOR3_2 = np.array([
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3,
], dtype=np.int64)
_ANCHOR3_3 = np.array([
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8,
], dtype=np.int64)

_WEIGHTS = {
    2: np.array([0, 21, 43, 64], dtype=np.int64),
    3: np.array([0, 9, 18, 27, 37, 46, 55, 64], dtype=np.int64),
    4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47,
                 51, 55, 60, 64], dtype=np.int64),
}

# Per-mode layout: (subsets, partition bits, rotation bits, index-selection
# bits, color bits, alpha bits, pbit kind, primary index bits, secondary
# index bits). Pbit kind: 'ep' = one per endpoint, 'sub' = one shared per
# subset, None = none.
_MODES = {
    0: (3, 4, 0, 0, 4, 0, "ep", 3, 0),
    1: (2, 6, 0, 0, 6, 0, "sub", 3, 0),
    2: (3, 6, 0, 0, 5, 0, None, 2, 0),
    3: (2, 6, 0, 0, 7, 0, "ep", 2, 0),
    4: (1, 0, 2, 1, 5, 6, None, 2, 3),
    5: (1, 0, 2, 0, 7, 8, None, 2, 2),
    6: (1, 0, 0, 0, 7, 7, "ep", 4, 0),
    7: (2, 6, 0, 0, 5, 5, "ep", 2, 0),
}


def _field(bits, lo, n):
    """bits: (M, 128) 0/1 -> integer field of n bits starting at lo."""
    if n == 0:
        return np.zeros(bits.shape[0], dtype=np.int64)
    w = (np.int64(1) << np.arange(n, dtype=np.int64))[None, :]
    return (bits[:, lo:lo + n].astype(np.int64) * w).sum(axis=1)


def _expand(val, nbits):
    """Dequantize an nbits endpoint value to 8 bits (shift + replicate)."""
    if nbits >= 8:
        return val
    return (val << (8 - nbits)) | (val >> (2 * nbits - 8))


def _unpack_indices(bits, base, ib, widths):
    """Per-texel index extraction with variable widths (anchor truncation).

    bits (M,128); base: stream start bit; widths (M,16) of ib or ib-1.
    Returns (M,16) int64.
    """
    m = bits.shape[0]
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


def _decode_mode(bits, mode):
    """Decode all blocks of one mode. bits: (M, 128). Returns (M,16,4) u8."""
    m = bits.shape[0]
    ns, pb, rb, isb, cb, ab, pkind, ib, ib2 = _MODES[mode]
    pos = mode + 1  # mode bits: `mode` zeros then a 1
    part = _field(bits, pos, pb); pos += pb
    rot = _field(bits, pos, rb); pos += rb
    idx_sel = _field(bits, pos, isb); pos += isb

    # endpoints, channel-major then (2*subset + ep) order
    nch = 3 + (1 if ab else 0)
    nep = 2 * ns
    raw = np.zeros((m, nch, nep), dtype=np.int64)
    for ch in range(nch):
        b = ab if (ch == 3) else cb
        for e in range(nep):
            raw[:, ch, e] = _field(bits, pos, b)
            pos += b

    # P-bits
    if pkind == "ep":
        pbits = np.stack([_field(bits, pos + e, 1) for e in range(nep)],
                         axis=1)  # (M, nep)
        pos += nep
    elif pkind == "sub":
        shared = np.stack([_field(bits, pos + s, 1) for s in range(ns)],
                          axis=1)
        pbits = np.repeat(shared, 2, axis=1)
        pos += ns
    else:
        pbits = None

    # dequantize to 8-bit
    ep = np.zeros((m, nch, nep), dtype=np.int64)
    for ch in range(nch):
        b = ab if (ch == 3) else cb
        v = raw[:, ch]
        if pbits is not None:
            v = (v << 1) | pbits
            b += 1
        ep[:, ch] = _expand(v, b)
    if ab == 0:
        alpha = np.full((m, nep), 255, dtype=np.int64)
        ep = np.concatenate([ep, alpha[:, None, :]], axis=1)

    # subset + anchor layout
    if ns == 1:
        subset = np.zeros((m, 16), dtype=np.int64)
        anchors = [np.zeros(m, dtype=np.int64)]
    elif ns == 2:
        subset = _P2[part]
        anchors = [np.zeros(m, dtype=np.int64), _ANCHOR2[part]]
    else:
        subset = _P3[part]
        anchors = [np.zeros(m, dtype=np.int64), _ANCHOR3_2[part],
                   _ANCHOR3_3[part]]

    def widths_for(nbits):
        w = np.full((m, 16), nbits, dtype=np.int64)
        cols = np.arange(16)[None, :]
        for a in anchors:
            w[cols == a[:, None]] -= 1
        return w

    idx1 = _unpack_indices(bits, pos, ib, widths_for(ib))
    pos += 16 * ib - len(anchors)
    if ib2:
        # two index streams: primary (ib-bit) drives color, secondary
        # (ib2-bit) drives alpha — unless mode 4's selection bit swaps them
        idx2 = _unpack_indices(bits, pos, ib2, widths_for(ib2))
        w1, w2 = _WEIGHTS[ib][idx1], _WEIGHTS[ib2][idx2]
        if isb:
            swap = idx_sel.astype(bool)[:, None]
            cw = np.where(swap, w2, w1)
            aw = np.where(swap, w1, w2)
        else:
            cw, aw = w1, w2
    else:
        cw = _WEIGHTS[ib][idx1]
        aw = cw

    # interpolate: ep (M, 4ch, nep) -> e0/e1 (M, 16, 4) picked by subset
    ep_t = ep.transpose(0, 2, 1)  # (M, nep, 4)
    rows3 = np.arange(m)[:, None, None]
    ch3 = np.arange(4)[None, None, :]
    e0 = ep_t[rows3, (2 * subset)[:, :, None], ch3]
    e1 = ep_t[rows3, (2 * subset + 1)[:, :, None], ch3]
    w = np.concatenate([np.repeat(cw[..., None], 3, axis=-1),
                        aw[..., None]], axis=-1)
    out = ((64 - w) * e0 + w * e1 + 32) >> 6  # (M, 16, 4)

    # rotation (modes 4/5): swap alpha with R/G/B
    if rb:
        for r in (1, 2, 3):
            sel = rot == r
            if np.any(sel):
                ch = r - 1
                tmp = out[sel][..., ch].copy()
                out[sel, :, ch] = out[sel, :, 3]
                out[sel, :, 3] = tmp
    return out.astype(np.uint8)


def decode_bc7_blocks(raw: np.ndarray) -> np.ndarray:
    """(N, 16) uint8 BC7 blocks -> (N, 16, 4) uint8 RGBA texels."""
    n = raw.shape[0]
    bits = np.unpackbits(raw, axis=1, bitorder="little")  # (N, 128)
    first_set = np.argmax(bits, axis=1)
    mode = np.where(bits.any(axis=1), first_set, 8)
    out = np.zeros((n, 16, 4), dtype=np.uint8)  # reserved modes -> 0
    for md in range(8):
        sel = np.nonzero(mode == md)[0]
        if sel.size:
            out[sel] = _decode_mode(bits[sel], md)
    return out


def decode_bc7(data: bytes, width: int, height: int) -> np.ndarray:
    """BC7: 16-byte blocks, 8 modes. Returns (H, W, 4) uint8."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    raw = np.frombuffer(data, dtype=np.uint8, count=n * 16).reshape(n, 16)
    texels = decode_bc7_blocks(raw)
    img = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return img.reshape(bh * 4, bw * 4, 4)[:height, :width].copy()
