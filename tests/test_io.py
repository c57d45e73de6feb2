import numpy as np
import pytest

from crychic_renderer_tpu.io import dds, mesh_txt

REF_TEX = "/root/reference/Textures"
REF_MODELS = "/root/reference/Models"


def test_load_skull():
    m = mesh_txt.load_mesh_txt(f"{REF_MODELS}/skull.txt")
    assert m.num_vertices == 31076
    assert m.num_triangles == 60339
    assert m.indices.max() < m.num_vertices
    # normals roughly unit
    n = np.linalg.norm(m.normals, axis=1)
    assert (np.abs(n - 1.0) < 0.1).mean() > 0.95
    # tangents unit and orthogonal-ish to normals
    t = np.linalg.norm(m.tangents, axis=1)
    assert np.allclose(t, 1.0, atol=1e-3)


def test_load_car():
    m = mesh_txt.load_mesh_txt(f"{REF_MODELS}/car.txt")
    assert m.num_vertices == 1860
    assert m.num_triangles == 1850


def test_load_dxt1():
    t = dds.load_dds(f"{REF_TEX}/tile.dds")
    assert not t.is_cubemap
    assert t.mips[0].shape[2] == 4
    assert t.mips[0].dtype == np.uint8
    # mip chain halves
    if len(t.mips) > 1:
        assert t.mips[1].shape[0] == max(t.mips[0].shape[0] // 2, 1)


def test_load_dxt5():
    t = dds.load_dds(f"{REF_TEX}/bricks2.dds")
    assert t.mips[0].shape == (512, 512, 4)
    assert len(t.mips) == 10
    # bricks are brownish-red: red channel should dominate blue on average
    m = t.mips[0].astype(np.float32)
    assert m[..., 0].mean() > m[..., 2].mean()


def test_load_rgba8_nmap():
    t = dds.load_dds(f"{REF_TEX}/default_nmap.dds")
    img = t.mips[0]
    # a flat normal map is (128, 128, 255, *): z-dominant
    assert img[..., 2].mean() > 200
    assert abs(float(img[..., 0].mean()) - 128) < 8


def test_white1x1():
    t = dds.load_dds(f"{REF_TEX}/white1x1.dds")
    assert t.mips[0].shape[:2] == (1, 1)
    assert (t.mips[0][0, 0, :3] == 255).all()


def test_generate_mips():
    base = np.full((8, 4, 4), 100, dtype=np.uint8)
    mips = dds.generate_mips(base)
    assert [m.shape[:2] for m in mips] == [(8, 4), (4, 2), (2, 1), (1, 1)]
    assert (mips[-1] == 100).all()


def test_load_bmp_anim_frame():
    import os

    frames = sorted(os.listdir(f"{REF_TEX}/BoltAnim"))
    img = dds.load_bmp(f"{REF_TEX}/BoltAnim/{frames[0]}")
    assert img.ndim == 3 and img.shape[2] == 4


def test_quad_pool_bilinear_matches_reference():
    """The quad-row pool sampler equals a naive 4-fetch wrap bilinear on
    the pool's uniform-size mip-0 image."""
    import jax.numpy as jnp
    from crychic_renderer_tpu.ops import sampling

    S = sampling.POOL_SIZE
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (S, S, 4), dtype=np.uint8)
    pool = sampling.PairPool.build([([img], [img])], n_big=1)
    n = 64
    uv = jnp.asarray(rng.uniform(-0.3, 1.3, (n, 2)).astype(np.float32))
    tex = jnp.zeros(n, jnp.int32)
    mip = jnp.zeros(n, jnp.int32)
    got = np.asarray(sampling.sample_pair_bilinear(pool, tex, uv, mip)[0])

    # naive reference
    f = img.astype(np.float32) / 255.0
    x = np.asarray(uv)[:, 0] * S - 0.5
    y = np.asarray(uv)[:, 1] * S - 0.5
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    c00 = f[y0 % S, x0 % S]
    c10 = f[y0 % S, (x0 + 1) % S]
    c01 = f[(y0 + 1) % S, x0 % S]
    c11 = f[(y0 + 1) % S, (x0 + 1) % S]
    ref = (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (
        c01 * (1 - fx) + c11 * fx) * fy
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_pool_mip_offsets_analytic():
    from crychic_renderer_tpu.ops import sampling

    # the analytic mip offset matches the straightforward sum
    acc = 0
    for m in range(sampling.POOL_MIPS + 1):
        assert sampling._mip_offset(m) == acc
        if m < sampling.POOL_MIPS:
            acc += (sampling.POOL_SIZE >> m) ** 2


def test_dds_dx10_texture_array():
    """treeArray2.dds ships with a DX10 header (R8G8B8A8, arraySize 3) —
    DDSTextureLoader.cpp:1694-1809 array handling."""
    import os

    path = "/root/reference/Textures/treeArray2.dds"
    if not os.path.exists(path):
        import pytest

        pytest.skip("reference asset not present")
    from crychic_renderer_tpu.io.dds import load_dds

    t = load_dds(path)
    assert len(t.layers) == 3
    assert t.mips[0].shape == (256, 208, 4)
    # layers differ (distinct tree billboards)
    assert not np.array_equal(t.layers[0][0], t.layers[1][0])


def _dds_header(w, h, fourcc=None, dx10=None, bpp=32, caps2=0, masks=None):
    import struct

    pf_flags = 0x4 if fourcc else 0x40
    four = fourcc or b"\0\0\0\0"
    if masks is None:
        masks = (0, 0, 0, 0) if fourcc else (
            0xFF, 0xFF00, 0xFF0000, 0xFF000000)
    head = struct.pack("<I7I", 0x20534444, 124, 0x1007, h, w, 0, 0, 1)
    head += b"\0" * 44
    head += struct.pack("<II4sIIIII", 32, pf_flags, four,
                        0 if fourcc else bpp, *masks)
    head += struct.pack("<II", 0x1000, caps2) + b"\0" * 12
    if dx10 is not None:
        head += struct.pack("<5I", *dx10)
    return head


def test_dds_bc2_decode():
    """Synthetic one-block DXT3 file: explicit 4-bit alpha + BC1 color."""
    import struct

    from crychic_renderer_tpu.io.dds import load_dds

    # alpha nibbles 0..15 over the block; color: c0=red, c1=blue, all
    # texels index 0 (c0)
    alpha = bytes(
        (2 * i + 1) << 4 | (2 * i) for i in range(8))  # texel i -> i
    c0 = 0xF800  # red in 565
    c1 = 0x001F
    color = struct.pack("<HHI", c0, c1, 0)  # all 2-bit indices = 0
    payload = alpha + color
    data = _dds_header(4, 4, fourcc=b"DXT3") + payload
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".dds", delete=False) as f:
        f.write(data)
        p = f.name
    t = load_dds(p)
    img = t.mips[0]
    assert img.shape == (4, 4, 4)
    # red channel saturated, blue/green 0
    assert (img[..., 0] == 255).all() and (img[..., 2] == 0).all()
    # alpha ramps 0..255 in 17-steps (4-bit * 255/15)
    flat_a = img.reshape(16, 4)[:, 3]
    np.testing.assert_array_equal(flat_a, (np.arange(16) * 17))


def test_dds_dx10_bc3():
    """DX10-header BC3 file decodes through the legacy DXT5 path."""
    import struct
    import tempfile

    from crychic_renderer_tpu.io.dds import load_dds

    # solid color block: alpha a0=a1=200 idx 0; color all c0=green
    ablock = struct.pack("<BB6s", 200, 200, b"\0" * 6)
    color = struct.pack("<HHI", 0x07E0, 0x07E0, 0)
    payload = ablock + color
    data = _dds_header(4, 4, fourcc=b"DX10",
                       dx10=(77, 3, 0, 1, 0)) + payload  # 77 = BC3_UNORM
    with tempfile.NamedTemporaryFile(suffix=".dds", delete=False) as f:
        f.write(data)
        p = f.name
    t = load_dds(p)
    img = t.mips[0]
    assert (img[..., 1] == 255).all()
    assert (img[..., 3] == 200).all()


def test_dds_bc4_decode(tmp_path):
    """Synthetic one-block BC4 (ATI1) file: single-channel interpolated
    block -> (r, 0, 0, 255) texels (DDSTextureLoader.cpp:585 ATI1 ->
    BC4_UNORM)."""
    import struct

    from crychic_renderer_tpu.io.dds import load_dds

    # r0=255 > r1=0: 8-entry interpolated palette; indices: texel i -> i%8
    idx = [i % 8 for i in range(16)]
    bits = 0
    for i, v in enumerate(idx):
        bits |= v << (3 * i)
    block = struct.pack("<BB", 255, 0) + bits.to_bytes(6, "little")
    p = tmp_path / "bc4.dds"
    p.write_bytes(_dds_header(4, 4, fourcc=b"ATI1") + block)
    img = load_dds(str(p)).mips[0]
    assert img.shape == (4, 4, 4)
    # palette: [255, 0, 6/7*255, 5/7*255, ...]
    expect = np.array([255, 0] + [round((7 - k) * 255 / 7) for k in
                                  range(1, 7)], dtype=np.uint8)
    flat = img.reshape(16, 4)
    np.testing.assert_array_equal(flat[:, 0], expect[np.array(idx)])
    assert (flat[:, 1] == 0).all() and (flat[:, 2] == 0).all()
    assert (flat[:, 3] == 255).all()


def test_dds_bc5_dx10_decode(tmp_path):
    """DX10-header BC5 (dxgi 83): red + green interpolated blocks ->
    (r, g, 0, 255)."""
    import struct

    from crychic_renderer_tpu.io.dds import load_dds

    # solid blocks: red all 100, green all 200 (a0=a1, idx 0)
    rblock = struct.pack("<BB6s", 100, 100, b"\0" * 6)
    gblock = struct.pack("<BB6s", 200, 200, b"\0" * 6)
    p = tmp_path / "bc5.dds"
    p.write_bytes(_dds_header(4, 4, fourcc=b"DX10",
                              dx10=(83, 3, 0, 1, 0)) + rblock + gblock)
    img = load_dds(str(p)).mips[0]
    assert (img[..., 0] == 100).all()
    assert (img[..., 1] == 200).all()
    assert (img[..., 2] == 0).all() and (img[..., 3] == 255).all()


def test_dds_16bpp_565(tmp_path):
    """Legacy-mask R5G6B5 file (GetDXGIFormat's D3DFMT_R5G6B5 row,
    DDSTextureLoader.cpp:557-700): 16-bpp mask decode."""
    import struct

    from crychic_renderer_tpu.io.dds import load_dds

    # 16 texels of pure green in 565 (0x07E0)
    payload = struct.pack("<H", 0x07E0) * 16
    p = tmp_path / "rgb565.dds"
    p.write_bytes(_dds_header(4, 4, bpp=16,
                              masks=(0xF800, 0x07E0, 0x001F, 0)) + payload)
    img = load_dds(str(p)).mips[0]
    assert (img[..., 1] == 255).all()
    assert (img[..., 0] == 0).all() and (img[..., 2] == 0).all()
    assert (img[..., 3] == 255).all()  # no alpha mask -> opaque


def test_dds_l8_dx10(tmp_path):
    """DX10 R8_UNORM (dxgi 61, the loader's L8 mapping) reads as
    (v, 0, 0, 255)."""
    from crychic_renderer_tpu.io.dds import load_dds

    payload = bytes(range(16))
    p = tmp_path / "l8.dds"
    p.write_bytes(_dds_header(4, 4, fourcc=b"DX10",
                              dx10=(61, 3, 0, 1, 0)) + payload)
    img = load_dds(str(p)).mips[0]
    np.testing.assert_array_equal(img.reshape(16, 4)[:, 0],
                                  np.arange(16, dtype=np.uint8))
    assert (img[..., 3] == 255).all()


def test_sky_cubemap_file_path(tmp_path):
    """A DDS cubemap file can replace the procedural sky end to end
    (LoadTextures gCubeMap path, CRYCHIC.cpp:960)."""
    import struct

    # 6 solid-color 4x4 RGBA8 faces: +X red, -X green, +Y blue, ...
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255),
              (255, 255, 0), (255, 0, 255), (0, 255, 255)]
    payload = b""
    for c in colors:
        texel = struct.pack("<BBBB", *c, 255)
        payload += texel * 16
    data = _dds_header(4, 4, caps2=0x200 | 0xFC00) + payload
    p = tmp_path / "cube.dds"
    p.write_bytes(data)

    from crychic_renderer_tpu.app.renderer import load_sky_cubemap

    faces = load_sky_cubemap(str(p))
    assert faces.shape == (6, 4, 4, 4)
    np.testing.assert_allclose(faces[2, 0, 0, :3], [0, 0, 1], atol=1e-3)

    # end to end: the sky (up direction) samples the +Y face -> blue
    import jax.numpy as jnp

    from crychic_renderer_tpu.ops import sampling

    packed = jnp.asarray(sampling.pack_cubemap(faces))
    up = jnp.asarray([[0.1, 1.0, 0.05]])
    col = np.asarray(sampling.sample_cubemap(packed, up))
    np.testing.assert_allclose(col[0, :3], [0, 0, 1], atol=2e-2)


# ---------------------------------------------------------------------------
# BC7 (io/bc7.py) — the DX10 BC7_UNORM(_SRGB) path of the reference's
# DDSTextureLoader format table (DDSTextureLoader.cpp:557-700).


def _bc7_bits(fields):
    """Pack (value, nbits) pairs LSB-first into a 16-byte BC7 block."""
    val = pos = 0
    for v, n in fields:
        val |= (int(v) & ((1 << n) - 1)) << pos
        pos += n
    assert pos <= 128
    return val.to_bytes(16, "little")


def test_dds_bc7_mode5_constant(tmp_path):
    """Hand-built mode-5 block: both endpoints = (R=127-ish) via 7-bit 0x40,
    alpha endpoints 0x80 -> constant color, no Pillow needed."""
    from crychic_renderer_tpu.io.dds import load_dds

    # mode 5: 6 mode bits (000001), rot=0, RGB 7-bit endpoints, A 8-bit
    fields = [(0b100000, 6), (0, 2)]
    for _ch in range(3):
        fields += [(0x40, 7), (0x40, 7)]       # ep0 = ep1 -> flat channel
    fields += [(0x80, 8), (0x80, 8)]           # alpha endpoints
    fields += [(0, 31), (0, 31)]               # color + alpha indices
    block = _bc7_bits(fields)
    p = tmp_path / "bc7.dds"
    p.write_bytes(_dds_header(4, 4, fourcc=b"DX10",
                              dx10=(98, 3, 0, 1, 0)) + block)
    img = load_dds(str(p)).mips[0]
    assert img.shape == (4, 4, 4)
    # 7-bit 0x40 expands to (0x40 << 1) = 0x80 -> 1000 0001 = 0x81? no:
    # (v << (8-7)) | (v >> (2*7-8)) = 0x80 | 0x01 = 0x81
    assert (img[..., :3] == 0x81).all()
    assert (img[..., 3] == 0x80).all()


def test_dds_bc7_reserved_mode_is_transparent_black(tmp_path):
    """All-zero mode bits = reserved block -> RGBA (0,0,0,0) per the D3D
    spec (hardware decoders return zero in all channels)."""
    from crychic_renderer_tpu.io.bc7 import decode_bc7

    img = decode_bc7(b"\0" * 16, 4, 4)
    assert (img == 0).all()


def test_bc7_fuzz_vs_pillow_all_modes():
    """Bit-exact fuzz of every BC7 mode against Pillow's independent BCn
    C decoder (reserved-mode blocks excluded: Pillow emits alpha 255 where
    the D3D spec says 0)."""
    import io as _io
    PIL_Image = pytest.importorskip("PIL.Image")
    from crychic_renderer_tpu.io.bc7 import decode_bc7

    rng = np.random.default_rng(42)
    nblk = 256
    for mode in range(8):
        raw = rng.integers(0, 256, size=(nblk, 16), dtype=np.uint8)
        keep = (raw[:, 0] >> (mode + 1)) << (mode + 1) if mode < 7 else 0
        raw[:, 0] = np.uint8(keep) | np.uint8(1 << mode)
        data = raw.tobytes()
        hdr = _dds_header(4, 4 * nblk, fourcc=b"DX10", dx10=(98, 3, 0, 1, 0))
        ref = np.asarray(
            PIL_Image.open(_io.BytesIO(hdr + data)).convert("RGBA"))
        mine = decode_bc7(data, 4, 4 * nblk)
        np.testing.assert_array_equal(mine, ref, err_msg=f"mode {mode}")


# ---------------------------------------------------------------------------
# BC6H (io/bc6h.py) — the DX10 BC6H_UF16/SF16 path of the reference's
# DDSTextureLoader format table (DDSTextureLoader.cpp:557-700). HDR: decodes
# to float32. The layout of all 14 modes was verified per-bit against
# Pillow through amplified probe blocks; the fuzz here re-checks every mode
# under Pillow emulation (Pillow deviates from the D3D spec in two measured
# ways: it skips the +32 interpolation rounding, and it omits the final
# sign-extension after the SF16 transformed delta add).


def _bc6h_block(mv, fields=None, d=0, idx_bits=0):
    """Build one 16-byte BC6H block from the decoder's own layout table."""
    from crychic_renderer_tpu.io.bc6h import _LAYOUTS, _MODE_INFO

    bits = np.zeros(128, dtype=np.uint8)
    ml = 2 if mv in (0, 1) else 5
    for k in range(ml):
        bits[k] = (mv >> k) & 1
    for pos, (field, sig) in enumerate(_LAYOUTS[mv], start=ml):
        bits[pos] = ((fields or {}).get(field, 0) >> sig) & 1
    if _MODE_INFO[mv][3]:
        for k in range(5):
            bits[77 + k] = (d >> k) & 1
        istart = 82
    else:
        istart = 65
    if idx_bits:
        bits[istart:] = 1
    return np.packbits(bits, bitorder="little").tobytes()


def test_dds_bc6h_constant_block(tmp_path):
    """Mode-11 (one-region, untransformed 10-bit) flat block loads through
    load_dds as float32 RGBA with the exact unquantized half values."""
    from crychic_renderer_tpu.io.dds import load_dds

    blk = _bc6h_block(3, {"rw": 512, "gw": 256, "bw": 128,
                          "rx": 512, "gx": 256, "bx": 128})
    p = tmp_path / "bc6h.dds"
    p.write_bytes(_dds_header(4, 4, fourcc=b"DX10",
                              dx10=(95, 3, 0, 1, 0)) + blk)
    img = load_dds(str(p)).mips[0]
    assert img.dtype == np.float32 and img.shape == (4, 4, 4)

    def expect(raw):
        unq = ((raw << 16) + 0x8000) >> 10
        return np.uint16((unq * 31) >> 6).view(np.float16).astype(np.float32)

    np.testing.assert_array_equal(img[..., 0], expect(512))
    np.testing.assert_array_equal(img[..., 1], expect(256))
    np.testing.assert_array_equal(img[..., 2], expect(128))
    np.testing.assert_array_equal(img[..., 3], 1.0)


def test_bc6h_reserved_mode_is_black():
    """Reserved 5-bit mode ids (19/23/27/31) decode to zero per the D3D
    spec (and per Pillow)."""
    from crychic_renderer_tpu.io.bc6h import decode_bc6h

    for mv in (19, 23, 27, 31):
        img = decode_bc6h(bytes([mv & 0x1F] + [0xFF] * 15), 4, 4)
        assert (img == 0).all()


def test_bc6h_signed_spec_sign_extension():
    """SF16 transformed wrap: base 0 + delta raw 256 (sign bit set, 9-bit
    delta) is -256 per the D3D spec -> small NEGATIVE output. Pillow's
    decoder omits the final sign extension (gets +max instead); the
    shipped path must follow the spec, the emulation knob must follow
    Pillow — both asserted."""
    from crychic_renderer_tpu.io.bc6h import decode_bc6h

    blk = _bc6h_block(7, {"rx": 256, "gx": 256, "bx": 256}, idx_bits=1)
    spec = decode_bc6h(blk, 4, 4, signed=True)
    emu = decode_bc6h(blk, 4, 4, signed=True, pillow_emulation=True)
    # spec: sext((0 - 256) & 2047, 11) = -256 -> unq -8208 -> -(7951/2^20)
    expected = -np.uint16(0x8000 | ((8208 * 31) >> 5)).view(
        np.float16).astype(np.float32) * -1.0
    flat = spec[..., 0].ravel()
    np.testing.assert_array_equal(flat[1:], expected)  # texel 0 = anchor
    assert (spec[..., 0] < 0).all()
    assert (emu[..., 0].ravel()[1:] == 65504.0).all()  # clamped +max half


def test_bc6h_fuzz_vs_pillow_all_modes():
    """Every BC6H mode, UF16 + SF16, random endpoint fields biased into
    the u8-visible range, exact u8 agreement with Pillow's independent
    BCn decoder (under the two documented Pillow deviations)."""
    import io as _io
    PIL_Image = pytest.importorskip("PIL.Image")
    from crychic_renderer_tpu.io.bc6h import (_LAYOUTS, _MODE_INFO,
                                              decode_bc6h)

    rng = np.random.default_rng(7)
    nblk = 96
    for mv, (epb, _d, _t, _two) in _MODE_INFO.items():
        for signed in (False, True):
            blocks = []
            for _ in range(nblk):
                fields = {}
                for f in set(f for f, _ in _LAYOUTS[mv]):
                    width = 1 + max(s for g, s in _LAYOUTS[mv] if g == f)
                    fields[f] = int(rng.integers(0, 1 << width))
                if rng.random() < 0.5:
                    sb = (30000 >> (16 - epb)) if epb < 15 else 29000
                    for c in "rgb":
                        fields[c + "w"] = max(
                            0, sb + int(rng.integers(-64, 64)))
                blocks.append(_bc6h_block(
                    mv, fields, d=int(rng.integers(0, 32)),
                    idx_bits=int(rng.integers(0, 2))))
            data = b"".join(blocks)
            hdr = _dds_header(4, 4 * nblk, fourcc=b"DX10",
                              dx10=(96 if signed else 95, 3, 0, 1, 0))
            ref = np.asarray(PIL_Image.open(_io.BytesIO(hdr + data)))
            mine = decode_bc6h(data, 4, 4 * nblk, signed=signed,
                               pillow_emulation=True)
            mine_u8 = np.floor(np.clip(mine, 0.0, 1.0) * 255.0).astype(
                np.uint8)
            np.testing.assert_array_equal(
                mine_u8, ref, err_msg=f"mode value {mv} signed={signed}")
