"""DDS texture loading: legacy + DX10 headers, BC1-BC5 + BC7 block decode,
mask-driven uncompressed formats at 8/16/24/32 bpp (RGBA8/BGRA8, R5G6B5,
A1R5G5B5, A4R4G4B4, R8G8B8, L8, A8), mip chains, cubemaps, texture
arrays — plus BMP frames for the animated textures.

Re-implements the capability of the reference's DDSTextureLoader
(/root/reference/Common/DDSTextureLoader.cpp: header parse :147, DX10
header + arrays :1694-1809, format mapping :557, mip/subresource layout
:897) for the format families the renderer consumes. Compressed textures
are decoded to RGBA8 on the host at load time: the renderer samples from
dense arrays with gathers, so decode-at-load takes the place of the
hardware BC sampler.

The pure-numpy decoders are vectorized over blocks; a C++ fast path
(native/asset_pipeline) overrides `decode_bc1/2/3` when built.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

DDS_MAGIC = 0x20534444  # 'DDS '
DDPF_FOURCC = 0x4
DDPF_RGB = 0x40
DDSCAPS2_CUBEMAP = 0x200
DDSCAPS2_CUBEMAP_ALLFACES = 0xFC00


@dataclass
class DDSTexture:
    """A loaded texture: list of mip levels, each (H, W, 4) uint8 RGBA.

    For cubemaps ``faces`` holds 6 entries (+X, -X, +Y, -Y, +Z, -Z order,
    i.e. D3D cubemap face order), each a list of mips. For texture arrays
    (DX10 header, arraySize > 1 — DDSTextureLoader.cpp:1758-1809)
    ``layers`` holds one mip list per array slice and ``mips`` aliases
    layer 0.
    """

    mips: list = field(default_factory=list)
    faces: list = field(default_factory=list)
    layers: list = field(default_factory=list)
    is_cubemap: bool = False

    @property
    def array_size(self):
        return max(len(self.layers), 1)

    @property
    def width(self):
        return (self.faces[0][0] if self.is_cubemap else self.mips[0]).shape[1]

    @property
    def height(self):
        return (self.faces[0][0] if self.is_cubemap else self.mips[0]).shape[0]


def _decode_rgb565(c: np.ndarray) -> np.ndarray:
    """(N,) uint16 -> (N, 3) float32 in [0, 255]."""
    r = ((c >> 11) & 0x1F).astype(np.float32) * (255.0 / 31.0)
    g = ((c >> 5) & 0x3F).astype(np.float32) * (255.0 / 63.0)
    b = (c & 0x1F).astype(np.float32) * (255.0 / 31.0)
    return np.stack([r, g, b], axis=-1)


def decode_bc1(data: bytes, width: int, height: int) -> np.ndarray:
    """DXT1: 8-byte 4x4 blocks, 2 RGB565 endpoints + 2-bit indices.

    Returns (H, W, 4) uint8. Handles the 1-bit-alpha mode (c0 <= c1).
    """
    from .. import native

    fast = native.decode_bc1(data, width, height)
    if fast is not None:
        return fast
    return _decode_bc1_numpy(data, width, height)


def _decode_bc1_numpy(data: bytes, width: int, height: int) -> np.ndarray:
    bw, bh = (width + 3) // 4, (height + 3) // 4
    arr = np.frombuffer(data, dtype="<u2", count=bw * bh * 4).reshape(bw * bh, 4)
    c0, c1 = arr[:, 0], arr[:, 1]
    bits = (arr[:, 2].astype(np.uint32) | (arr[:, 3].astype(np.uint32) << 16))
    p0 = _decode_rgb565(c0)
    p1 = _decode_rgb565(c1)
    opaque = (c0 > c1)[:, None]
    p2 = np.where(opaque, (2 * p0 + p1) / 3.0, (p0 + p1) / 2.0)
    p3 = np.where(opaque, (p0 + 2 * p1) / 3.0, 0.0)
    palette = np.stack([p0, p1, p2, p3], axis=1)  # (N, 4, 3)
    alpha = np.ones((palette.shape[0], 4, 1), dtype=np.float32) * 255.0
    alpha[:, 3, 0] = np.where(opaque[:, 0], 255.0, 0.0)
    palette = np.concatenate([palette, alpha], axis=-1)  # (N, 4, 4)

    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    idx = (bits[:, None] >> shifts) & 0x3  # (N, 16)
    texels = np.take_along_axis(palette, idx[..., None].astype(np.int64), axis=1)
    img = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, 4)[:height, :width]
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def decode_bc2(data: bytes, width: int, height: int) -> np.ndarray:
    """DXT3: 16-byte blocks = 8 bytes of explicit 4-bit alpha + a BC1-style
    color block in the (always) 4-color mode (DDSTextureLoader.cpp maps
    DXT2/DXT3 to DXGI_FORMAT_BC2_UNORM, :569-574)."""
    from .. import native

    fast = native.decode_bc2(data, width, height)
    if fast is not None:
        return fast
    return _decode_bc2_numpy(data, width, height)


def _decode_bc2_numpy(data: bytes, width: int, height: int) -> np.ndarray:
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    raw = np.frombuffer(data, dtype=np.uint8, count=n * 16).reshape(n, 16)
    # 16 4-bit alphas, little-endian nibbles: texel i -> byte i//2
    abytes = raw[:, :8]
    lo = (abytes & 0x0F).astype(np.float32) * (255.0 / 15.0)
    hi = ((abytes >> 4) & 0x0F).astype(np.float32) * (255.0 / 15.0)
    alpha = np.stack([lo, hi], axis=-1).reshape(n, 16)

    color = raw[:, 8:].copy().view("<u2").reshape(n, 4)
    c0, c1 = color[:, 0], color[:, 1]
    bits = color[:, 2].astype(np.uint32) | (color[:, 3].astype(np.uint32) << 16)
    p0, p1 = _decode_rgb565(c0), _decode_rgb565(c1)
    palette = np.stack([p0, p1, (2 * p0 + p1) / 3.0, (p0 + 2 * p1) / 3.0],
                       axis=1)
    cshifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    cidx = ((bits[:, None] >> cshifts) & 0x3).astype(np.int64)
    rgb = np.take_along_axis(palette, cidx[..., None], axis=1)  # (N, 16, 3)
    texels = np.concatenate([rgb, alpha[..., None]], axis=-1)
    img = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, 4)[:height, :width]
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def _decode_bc_alpha_block(raw8: np.ndarray) -> np.ndarray:
    """Decode the shared BC3/BC4/BC5 interpolated single-channel block.

    ``raw8`` is (N, 8) uint8: 2 endpoint bytes + 6 bytes of 3-bit indices.
    Returns (N, 16) float32 values in [0, 255]. This is the 8-byte block
    the reference GPU decodes natively for BC3 alpha / BC4 red / BC5 red
    and green (DDSTextureLoader.cpp maps ATI1/ATI2 + DX10 BC4/BC5 ids at
    :585-607 and never decodes — this renderer decodes at load time).
    """
    n = raw8.shape[0]
    a0 = raw8[:, 0].astype(np.float32)
    a1 = raw8[:, 1].astype(np.float32)
    abits = np.zeros(n, dtype=np.uint64)
    for i in range(6):
        abits |= raw8[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    shifts = (np.arange(16, dtype=np.uint64) * np.uint64(3))[None, :]
    aidx = ((abits[:, None] >> shifts) & np.uint64(7)).astype(np.int64)  # (N,16)
    gt = (a0 > a1)[:, None]
    # palettes for the two modes
    pal_gt = np.empty((n, 8), dtype=np.float32)
    pal_gt[:, 0], pal_gt[:, 1] = a0, a1
    for i in range(1, 7):
        pal_gt[:, i + 1] = ((7 - i) * a0 + i * a1) / 7.0
    pal_le = np.empty((n, 8), dtype=np.float32)
    pal_le[:, 0], pal_le[:, 1] = a0, a1
    for i in range(1, 5):
        pal_le[:, i + 1] = ((5 - i) * a0 + i * a1) / 5.0
    pal_le[:, 6] = 0.0
    pal_le[:, 7] = 255.0
    pal = np.where(gt, pal_gt, pal_le)
    return np.take_along_axis(pal, aidx, axis=1)  # (N, 16)


def _blocks_to_image(texels: np.ndarray, bw: int, bh: int,
                     width: int, height: int) -> np.ndarray:
    """(N, 16, 4) float32 per-block texels -> (H, W, 4) uint8 image."""
    img = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, 4)[:height, :width]
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def decode_bc3(data: bytes, width: int, height: int) -> np.ndarray:
    """DXT5: 16-byte blocks = 8-byte interpolated alpha + BC1-style color."""
    from .. import native

    fast = native.decode_bc3(data, width, height)
    if fast is not None:
        return fast
    return _decode_bc3_numpy(data, width, height)


def _decode_bc3_numpy(data: bytes, width: int, height: int) -> np.ndarray:
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    raw = np.frombuffer(data, dtype=np.uint8, count=n * 16).reshape(n, 16)
    alpha = _decode_bc_alpha_block(raw[:, :8])  # (N, 16)

    color = raw[:, 8:].copy().view("<u2").reshape(n, 4)
    c0, c1 = color[:, 0], color[:, 1]
    bits = color[:, 2].astype(np.uint32) | (color[:, 3].astype(np.uint32) << 16)
    p0, p1 = _decode_rgb565(c0), _decode_rgb565(c1)
    # BC3 color block always uses the 4-color (opaque) mode
    palette = np.stack([p0, p1, (2 * p0 + p1) / 3.0, (p0 + 2 * p1) / 3.0], axis=1)
    cshifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    cidx = ((bits[:, None] >> cshifts) & 0x3).astype(np.int64)
    rgb = np.take_along_axis(palette, cidx[..., None], axis=1)  # (N, 16, 3)
    texels = np.concatenate([rgb, alpha[..., None]], axis=-1)
    return _blocks_to_image(texels, bw, bh, width, height)


def decode_bc4(data: bytes, width: int, height: int) -> np.ndarray:
    """BC4 (ATI1): 8-byte single-channel blocks. Returns (H, W, 4) uint8
    with D3D's BC4_UNORM sampling semantics — (r, 0, 0, 1)
    (DDSTextureLoader.cpp:585 'ATI1' -> DXGI_FORMAT_BC4_UNORM)."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    raw = np.frombuffer(data, dtype=np.uint8, count=n * 8).reshape(n, 8)
    red = _decode_bc_alpha_block(raw)  # (N, 16)
    texels = np.zeros((n, 16, 4), dtype=np.float32)
    texels[..., 0] = red
    texels[..., 3] = 255.0
    return _blocks_to_image(texels, bw, bh, width, height)


def decode_bc5(data: bytes, width: int, height: int) -> np.ndarray:
    """BC5 (ATI2): 16-byte two-channel blocks (red block + green block).
    Returns (H, W, 4) uint8 with BC5_UNORM sampling semantics —
    (r, g, 0, 1) (DDSTextureLoader.cpp:590 'ATI2' -> BC5_UNORM)."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    raw = np.frombuffer(data, dtype=np.uint8, count=n * 16).reshape(n, 16)
    red = _decode_bc_alpha_block(raw[:, :8])
    green = _decode_bc_alpha_block(raw[:, 8:])
    texels = np.zeros((n, 16, 4), dtype=np.float32)
    texels[..., 0] = red
    texels[..., 1] = green
    texels[..., 3] = 255.0
    return _blocks_to_image(texels, bw, bh, width, height)


def _decode_uncompressed(data: bytes, width: int, height: int, pf) -> np.ndarray:
    """Mask-driven uncompressed decode at 8/16/24/32 bpp — the numpy
    equivalent of the reference's legacy-mask table (GetDXGIFormat,
    DDSTextureLoader.cpp:557-700: A8R8G8B8/X8R8G8B8/R5G6B5/A1R5G5B5/
    A4R4G4B4/R8G8B8/L8/...). Missing masks read as 255 (alpha) / the
    luminance replication is handled by the caller via the mask values."""
    bpp = pf["rgb_bit_count"]
    assert bpp in (8, 16, 24, 32), f"unsupported uncompressed bpp {bpp}"
    nbytes = bpp // 8
    raw = np.frombuffer(data, dtype=np.uint8, count=width * height * nbytes)
    raw = raw.reshape(height, width, nbytes).astype(np.uint32)
    # compose little-endian pixel words of any byte width
    u32 = np.zeros((height, width), dtype=np.uint32)
    for b in range(nbytes):
        u32 |= raw[..., b] << np.uint32(8 * b)
    out = np.empty((height, width, 4), dtype=np.uint8)
    masks = [pf["r_mask"], pf["g_mask"], pf["b_mask"], pf["a_mask"]]
    for ch, mask in enumerate(masks):
        if mask == 0:
            out[..., ch] = 255 if ch == 3 else 0
            continue
        shift = (mask & -mask).bit_length() - 1
        width_bits = int(mask >> shift).bit_length()
        vals = (u32 >> shift) & (mask >> shift)
        if width_bits < 8:
            vals = (vals * 255) // ((1 << width_bits) - 1)
        out[..., ch] = vals.astype(np.uint8)
    return out


def _mip_dims(w, h, level):
    return max(w >> level, 1), max(h >> level, 1)


def _level_bytes(w, h, fourcc, bpp):
    if fourcc in (b"DXT1", b"ATI1", b"BC4U"):
        return ((w + 3) // 4) * ((h + 3) // 4) * 8
    if fourcc in (b"DXT2", b"DXT3", b"DXT4", b"DXT5", b"ATI2", b"BC5U",
                  b"BC7 ", b"BC6H", b"BC6S"):
        return ((w + 3) // 4) * ((h + 3) // 4) * 16
    return w * h * (bpp // 8)


# DXGI formats the asset pipeline accepts from DX10-header files, mapped
# onto the legacy decode paths (GetDXGIFormat's inverse for the subset the
# renderer consumes — DDSTextureLoader.cpp:557-700).
_DXGI_TO_FOURCC = {
    71: b"DXT1", 72: b"DXT1",           # BC1_UNORM(_SRGB)
    74: b"DXT3", 75: b"DXT3",           # BC2_UNORM(_SRGB)
    77: b"DXT5", 78: b"DXT5",           # BC3_UNORM(_SRGB)
    80: b"ATI1",                        # BC4_UNORM
    83: b"ATI2",                        # BC5_UNORM
    94: b"BC6H", 95: b"BC6H",           # BC6H_TYPELESS/UF16 — io/bc6h.py
    96: b"BC6S",                        # BC6H_SF16 — io/bc6h.py
    98: b"BC7 ", 99: b"BC7 ",           # BC7_UNORM(_SRGB) — io/bc7.py
}
_DXGI_RGBA_MASKS = {
    # dxgi id -> (bpp, r, g, b, a masks) for the uncompressed path
    # (the inverse of GetDXGIFormat's mask table, DDSTextureLoader.cpp:557)
    28: (32, 0xFF, 0xFF00, 0xFF0000, 0xFF000000),    # R8G8B8A8_UNORM
    29: (32, 0xFF, 0xFF00, 0xFF0000, 0xFF000000),    # R8G8B8A8_UNORM_SRGB
    87: (32, 0xFF0000, 0xFF00, 0xFF, 0xFF000000),    # B8G8R8A8_UNORM
    91: (32, 0xFF0000, 0xFF00, 0xFF, 0xFF000000),    # B8G8R8A8_UNORM_SRGB
    88: (32, 0xFF0000, 0xFF00, 0xFF, 0),             # B8G8R8X8_UNORM
    85: (16, 0xF800, 0x07E0, 0x001F, 0),             # B5G6R5_UNORM
    86: (16, 0x7C00, 0x03E0, 0x001F, 0x8000),        # B5G5R5A1_UNORM
    115: (16, 0x0F00, 0x00F0, 0x000F, 0xF000),       # B4G4R4A4_UNORM
    61: (8, 0xFF, 0, 0, 0),                          # R8_UNORM (legacy L8)
    65: (8, 0, 0, 0, 0xFF),                          # A8_UNORM
}
_DX10_MISC_TEXTURECUBE = 0x4  # D3D11_RESOURCE_MISC_TEXTURECUBE


def load_dds(path: str) -> DDSTexture:
    with open(path, "rb") as f:
        data = f.read()
    magic, = struct.unpack_from("<I", data, 0)
    assert magic == DDS_MAGIC, f"{path}: not a DDS file"
    (size, flags, height, width, pitch, depth, mip_count) = struct.unpack_from(
        "<7I", data, 4
    )
    mip_count = max(mip_count, 1)
    # pixel format at offset 4+72
    (pf_size, pf_flags, fourcc, rgb_bit_count, r_mask, g_mask, b_mask,
     a_mask) = struct.unpack_from("<II4sIIIII", data, 4 + 72)
    caps1, caps2 = struct.unpack_from("<II", data, 4 + 104)
    pf = dict(rgb_bit_count=rgb_bit_count, r_mask=r_mask, g_mask=g_mask,
              b_mask=b_mask, a_mask=a_mask)
    offset = 4 + 124
    array_size = 1
    is_cube = bool(caps2 & DDSCAPS2_CUBEMAP)
    if pf_flags & DDPF_FOURCC and fourcc == b"DX10":
        # DX10 extended header (DDSTextureLoader.cpp DDS_HEADER_DXT10
        # handling, :1694-1750): dxgiFormat, resourceDimension, miscFlag,
        # arraySize, miscFlags2
        dxgi, rdim, misc, array_size, _misc2 = struct.unpack_from(
            "<5I", data, offset)
        offset += 20
        array_size = max(array_size, 1)
        is_cube = is_cube or bool(misc & _DX10_MISC_TEXTURECUBE)
        if dxgi in _DXGI_TO_FOURCC:
            fourcc = _DXGI_TO_FOURCC[dxgi]
            pf_flags |= DDPF_FOURCC
        elif dxgi in _DXGI_RGBA_MASKS:
            rgb_bit_count, r_mask, g_mask, b_mask, a_mask = \
                _DXGI_RGBA_MASKS[dxgi]
            pf = dict(rgb_bit_count=rgb_bit_count, r_mask=r_mask,
                      g_mask=g_mask, b_mask=b_mask, a_mask=a_mask)
            pf_flags &= ~DDPF_FOURCC
        else:
            raise NotImplementedError(f"{path}: DXGI format {dxgi}")

    num_items = array_size * (6 if is_cube else 1)
    compressed = bool(pf_flags & DDPF_FOURCC)

    tex = DDSTexture(is_cubemap=is_cube)
    pos = offset
    for _ in range(num_items):
        mips = []
        for level in range(mip_count):
            w, h = _mip_dims(width, height, level)
            nbytes = _level_bytes(w, h, fourcc if compressed else None,
                                  rgb_bit_count)
            chunk = data[pos:pos + nbytes]
            pos += nbytes
            if compressed and fourcc == b"DXT1":
                img = decode_bc1(chunk, w, h)
            elif compressed and fourcc in (b"DXT2", b"DXT3"):
                img = decode_bc2(chunk, w, h)
            elif compressed and fourcc in (b"DXT4", b"DXT5"):
                img = decode_bc3(chunk, w, h)
            elif compressed and fourcc in (b"ATI1", b"BC4U"):
                img = decode_bc4(chunk, w, h)
            elif compressed and fourcc in (b"ATI2", b"BC5U"):
                img = decode_bc5(chunk, w, h)
            elif compressed and fourcc == b"BC7 ":
                from .bc7 import decode_bc7
                img = decode_bc7(chunk, w, h)
            elif compressed and fourcc in (b"BC6H", b"BC6S"):
                # HDR half-float RGB: this is the one format whose mips
                # are float32 RGBA (exact half values, alpha=1), not u8
                from .bc6h import decode_bc6h
                rgb = decode_bc6h(chunk, w, h, signed=fourcc == b"BC6S")
                img = np.concatenate(
                    [rgb, np.ones_like(rgb[..., :1])], axis=-1)
            elif compressed:
                raise NotImplementedError(f"fourCC {fourcc!r}")
            else:
                img = _decode_uncompressed(chunk, w, h, pf)
            mips.append(img)
        if is_cube:
            tex.faces.append(mips)
        else:
            tex.layers.append(mips)
    if not is_cube:
        tex.mips = tex.layers[0]
    return tex


def generate_mips(base: np.ndarray) -> list:
    """Box-filter mip chain down to 1x1 (for textures shipped mipless)."""
    mips = [base]
    cur = base.astype(np.float32)
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h = max(cur.shape[0] // 2, 1)
        w = max(cur.shape[1] // 2, 1)
        cur2 = cur[: h * 2, : w * 2]
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            cur = 0.25 * (cur2[0::2, 0::2] + cur2[1::2, 0::2]
                          + cur2[0::2, 1::2] + cur2[1::2, 1::2])
        elif cur.shape[0] > 1:
            cur = 0.5 * (cur2[0::2] + cur2[1::2])
        else:
            cur = 0.5 * (cur2[:, 0::2] + cur2[:, 1::2])
        mips.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))
    return mips


def load_bmp(path: str) -> np.ndarray:
    """Minimal BMP loader (24-bit uncompressed) for BoltAnim/FireAnim frames."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:2] == b"BM", f"{path}: not a BMP"
    pix_offset, = struct.unpack_from("<I", data, 10)
    header_size, = struct.unpack_from("<I", data, 14)
    width, height = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    compression, = struct.unpack_from("<I", data, 30)
    assert compression == 0 and bpp in (24, 32), f"{path}: unsupported BMP"
    flip = height > 0
    height = abs(height)
    row_bytes = ((width * (bpp // 8) + 3) // 4) * 4
    raw = np.frombuffer(data, dtype=np.uint8, count=row_bytes * height,
                        offset=pix_offset)
    raw = raw.reshape(height, row_bytes)[:, : width * (bpp // 8)]
    raw = raw.reshape(height, width, bpp // 8)
    if flip:
        raw = raw[::-1]
    rgba = np.empty((height, width, 4), dtype=np.uint8)
    rgba[..., 0] = raw[..., 2]  # BGR -> RGB
    rgba[..., 1] = raw[..., 1]
    rgba[..., 2] = raw[..., 0]
    rgba[..., 3] = raw[..., 3] if bpp == 32 else 255
    return rgba
