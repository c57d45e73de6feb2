"""SSAO: 14-sample hemisphere occlusion at half resolution + edge-preserving
separable bilateral blur.

Re-implements /root/reference/Shaders/Ssao.hlsl (view-ray reconstruction,
random-vector reflection, linear occlusion falloff, pow-6 sharpening) and
SsaoBlur.hlsl (radius-5 Gaussian, normal/depth edge stop, weight
renormalization), plus the host-side setup from Ssao.cpp: the 14
cube-corner/face offset vectors with MSVC-rand lengths (Ssao.cpp:423-461),
the 256x256 random-vector texture (:352-421), and sigma-2.5 Gaussian
weights (:37-68). The SSAO map is half-resolution (Ssao.cpp:22-30); the
depth sampler has an opaque-white border (off-screen depth = 1).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils.msvcrand import MsvcRand


def build_offset_vectors() -> np.ndarray:
    """14 offsets: 8 cube corners + 6 face centers, random length
    [0.25, 1] from the MSVC rand stream (Ssao.cpp:423-461)."""
    base = np.array(
        [
            [+1, +1, +1], [-1, -1, -1], [-1, +1, +1], [+1, -1, -1],
            [+1, +1, -1], [-1, -1, +1], [-1, +1, -1], [+1, -1, +1],
            [-1, 0, 0], [+1, 0, 0], [0, -1, 0], [0, +1, 0],
            [0, 0, -1], [0, 0, +1],
        ],
        dtype=np.float32,
    )
    rnd = MsvcRand(seed=1)
    out = np.zeros((14, 3), np.float32)
    for i in range(14):
        s = rnd.randf_range(0.25, 1.0)
        v = base[i] / np.linalg.norm(base[i])
        out[i] = s * v
    return out


def build_random_vector_texture() -> np.ndarray:
    """256^2 RGBA8-quantized random vectors in [0,1] (Ssao.cpp:352-421).

    The reference fills it from the same global MSVC rand stream right
    after the offset vectors; XMCOLOR quantizes to 8 bits per channel.
    """
    from .. import native

    fast = native.msvc_random_texture(256, 1, 14)
    if fast is not None:
        return fast

    rnd = MsvcRand(seed=1)
    for _ in range(14):
        rnd.randf_range(0.25, 1.0)  # consume the offset-vector draws
    tex = np.zeros((256, 256, 3), np.float32)
    for i in range(256):
        for j in range(256):
            v = (rnd.randf(), rnd.randf(), rnd.randf())
            tex[i, j] = v
    tex = np.round(np.clip(tex, 0, 1) * 255.0) / 255.0
    return tex.astype(np.float32)


def calc_gauss_weights(sigma: float = 2.5) -> np.ndarray:
    """Ssao.cpp:37-68: normalized Gaussian, radius = ceil(2*sigma) = 5."""
    radius = int(np.ceil(2.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    w = np.exp(-x * x / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def ndc_depth_to_view(z_ndc, proj_22, proj_32):
    """Ssao.hlsl:110-115: viewZ = B / (z_ndc - A), A=proj[2][2], B=proj[3][2]."""
    return proj_32 / (z_ndc - proj_22)


def _quad_rows(depth_map):
    """(H, W) -> ((H*W, 4), W): each texel's 2x2 neighborhood as one row.
    The 14 occluder taps fetch one 16-byte quad row each instead of four
    scalar rows and use all 4 lanes for the bilinear blend (not yet
    measured on the GPU; ROADMAP S5)."""
    f = depth_map
    fx = jnp.roll(f, -1, axis=1)
    fy = jnp.roll(f, -1, axis=0)
    fxy = jnp.roll(fx, -1, axis=0)
    rows = jnp.stack([f.reshape(-1), fx.reshape(-1), fy.reshape(-1),
                      fxy.reshape(-1)], axis=-1)
    return rows, depth_map.shape[1]


def _pad_border_white(depth_map):
    """(H, W) -> (H+2, W+2): one texel of opaque-white border on every
    side. Quad rows built on the padded map make the bilinear tap's
    border-white addressing free: any wrap of _quad_rows' roll past the
    padded edge lands on another border texel (value 1.0)."""
    return jnp.pad(depth_map, 1, constant_values=1.0)


def _tap_depth_bilinear_white(rows, H, W, u, v):
    """One gsamDepthMap tap (Ssao.hlsl:126,164 via CRYCHIC.cpp
    BuildSsaoRootSignature s2: MIN_MAG_MIP_LINEAR, ADDRESS_BORDER,
    OPAQUE_WHITE): bilinear depth with off-screen texels reading 1.0.

    rows: quad rows of the PADDED map (_quad_rows(_pad_border_white(d)));
    H, W: the UNPADDED map size; u, v in [0,1] texture space. One row
    gather per tap.
    """
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    # padded-map quad at (x0+1, y0+1) covers unpadded corners x0..x0+1
    xq = jnp.clip(x0i + 1, 0, W + 1)
    yq = jnp.clip(y0i + 1, 0, H + 1)
    q = rows[yq * (W + 2) + xq]  # (..., 4) — ONE row gather per tap
    top = q[..., 0] * (1 - fx) + q[..., 1] * fx
    bot = q[..., 2] * (1 - fx) + q[..., 3] * fx
    d = top * (1 - fy) + bot * fy
    far = (x0i < -1) | (x0i > W) | (y0i < -1) | (y0i > H)
    return jnp.where(far, 1.0, d)


def pack_random_texture(tex: np.ndarray) -> np.ndarray:
    """(256, 256, 3) float [0,1] -> (256, 256) uint32 RGBA8."""
    u = np.clip(np.asarray(tex) * 255.0 + 0.5, 0, 255).astype(np.uint32)
    return u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)


def build_random_field(tex: np.ndarray, h: int, w: int) -> np.ndarray:
    """Precompute the per-pixel random VECTORS for an (h, w) SSAO grid.

    The random-vector fetch (Ssao.hlsl:138: gRandomVecMap sampled with
    gsamLinearWrap at 4x-tiled screen uv) has data-INDEPENDENT indices —
    the whole field is frame constant. Folding the gather out of the frame
    saves one ~10ns gather row per SSAO pixel per frame. Replicates the
    reference sampler exactly: RGBA8 quantization of the texture, then
    BILINEAR filtering with WRAP addressing of the quantized texels at
    u = 4*TexC (the round trip the D3D sampler performs), then the
    2x-1 decode.
    """
    t = np.asarray(tex, np.float32)
    q = np.floor(np.clip(t * 255.0 + 0.5, 0, 255)).astype(np.float32) / 255.0
    S = q.shape[0]
    U = ((np.arange(w, dtype=np.float32) + np.float32(0.5))
         / np.float32(w)).astype(np.float32)
    V = ((np.arange(h, dtype=np.float32) + np.float32(0.5))
         / np.float32(h)).astype(np.float32)
    x = U * np.float32(4.0) * np.float32(S) - np.float32(0.5)
    y = V * np.float32(4.0) * np.float32(S) - np.float32(0.5)
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = (x - x0).astype(np.float32)[None, :, None]
    fy = (y - y0).astype(np.float32)[:, None, None]
    xa = x0.astype(np.int64) % S
    ya = y0.astype(np.int64) % S
    xb = (xa + 1) % S
    yb = (ya + 1) % S
    c00 = q[ya][:, xa]
    c10 = q[ya][:, xb]
    c01 = q[yb][:, xa]
    c11 = q[yb][:, xb]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    samp = top * (1 - fy) + bot * fy
    return (2.0 * samp - 1.0).astype(np.float32)


def ssao_occlusion(normal_v, depth_ndc, proj, inv_proj, offsets,
                   random_tex=None,
                   occlusion_radius=0.5, fade_start=0.2, fade_end=1.0,
                   surface_eps=0.05, tap_depth=None, row_offset=0,
                   full_height=None, random_field=None, pixel_uv=None):
    """Half-res SSAO occlusion pass (Ssao.hlsl PS).

    normal_v: (h, w, 3) view-space normals (half-res); depth_ndc: (h, w)
    main depth downsampled to half-res (the box mean equals the
    reference's LINEAR center-depth fetch at ssao_scale=2 with even
    dimensions). proj/inv_proj: (4, 4) row-vector. Returns (h, w) ambient
    access in [0, 1].

    tap_depth: the FULL-RESOLUTION NDC depth map the 14 occluder taps
    sample — the reference binds the full-res depth buffer and samples it
    with gsamDepthMap (MIN_MAG_MIP_LINEAR, border OPAQUE_WHITE,
    Ssao.hlsl:164); taps here are bilinear border-white quad-row gathers.
    None falls back to depth_ndc (unit tests where the SSAO grid IS the
    depth grid).

    Band rendering (parallel.sharded): when this computes rows
    [row_offset, row_offset + h) of a full_height-row screen, the NDC view
    rays and the random-texture tiling must use GLOBAL rows, and
    ``tap_depth`` must be the all-gathered full-screen depth — the taps
    land anywhere on screen (Ssao.hlsl:67-69 reconstructs rays from
    full-frame NDC).

    pixel_uv: optional (U, V) texture-space uv per evaluated pixel (any
    leading shape matching depth_ndc/normal_v/random_field) — the
    tile-compacted path (passes.frame._ssao_occlusion_compacted)
    evaluates occlusion only at occupied tiles, so the pixel grid is no
    longer the array grid. Requires random_field (the compacted caller
    gathers the frame-constant field alongside its inputs).
    """
    if tap_depth is None:
        tap_depth = depth_ndc
    A22, B32 = proj[2, 2], proj[3, 2]

    if pixel_uv is not None:
        assert random_field is not None
        U, V = pixel_uv
    else:
        h, w = depth_ndc.shape
        if full_height is None:
            full_height = h
        # view-space ray through each pixel (quad corners -> inv proj)
        uu = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
        vv = (jnp.arange(h, dtype=jnp.float32)
              + row_offset + 0.5) / full_height
        U, V = jnp.meshgrid(uu, vv)  # 'xy' indexing: both (h, w)
    ndc = jnp.stack([2 * U - 1, 1 - 2 * V, jnp.zeros_like(U),
                     jnp.ones_like(U)], axis=-1)
    from .shading import rowmat

    ph = rowmat(ndc, inv_proj)
    pos_v_ray = ph[..., :3] / ph[..., 3:4]

    pz = ndc_depth_to_view(depth_ndc, A22, B32)
    p = (pz / pos_v_ray[..., 2])[..., None] * pos_v_ray

    if random_field is not None:
        # precomputed per-pixel vectors (see build_random_field): the
        # random-vector fetch has frame-constant indices, so the frame
        # path folds the gather out entirely
        rand_vec = random_field
    else:
        # random vector: texture tiled 4x over screen uv, point sampled.
        # The texture arrives RGBA8-packed in uint32 — a (n, 3) gather
        # result would be lane-padded 42x; a flat u32 gather is compact.
        from .sampling import unpack_rgba8

        ru = (U * 4.0) % 1.0
        rv = (V * 4.0) % 1.0
        rx = jnp.clip((ru * 256).astype(jnp.int32), 0, 255)
        ry = jnp.clip((rv * 256).astype(jnp.int32), 0, 255)
        if random_tex.dtype == jnp.uint32:
            rand_vec = 2.0 * unpack_rgba8(random_tex[ry, rx])[..., :3] - 1.0
        else:
            rand_vec = 2.0 * random_tex[ry, rx] - 1.0

    n = normal_v / jnp.maximum(
        jnp.sqrt((normal_v ** 2).sum(-1, keepdims=True)), 1e-8)

    occlusion_sum = jnp.zeros_like(pz)
    fade_len = fade_end - fade_start
    tap_rows, _ = _quad_rows(_pad_border_white(tap_depth))
    th, tw = tap_depth.shape
    for i in range(offsets.shape[0]):
        off = jnp.asarray(offsets[i])
        # reflect(offset, randVec) = off - 2*dot(off, rv)*rv
        refl = off - 2.0 * (rand_vec * off).sum(-1, keepdims=True) * rand_vec
        flip = jnp.sign((refl * n).sum(-1, keepdims=True))
        q = p + flip * occlusion_radius * refl
        # project q with proj, into texture space (u = x*0.5+0.5, v flip)
        qh = rowmat(
            jnp.concatenate([q, jnp.ones_like(q[..., :1])], -1), proj)
        qn = qh[..., :3] / jnp.maximum(qh[..., 3:4], 1e-8)
        qu = qn[..., 0] * 0.5 + 0.5
        qv = -qn[..., 1] * 0.5 + 0.5
        rz_ndc = _tap_depth_bilinear_white(tap_rows, th, tw, qu, qv)
        rz = ndc_depth_to_view(rz_ndc, A22, B32)
        r = (rz / jnp.where(q[..., 2] == 0, 1e-8, q[..., 2]))[..., None] * q
        dist_z = p[..., 2] - r[..., 2]
        rp = r - p
        dp = jnp.maximum(
            (n * rp).sum(-1)
            / jnp.maximum(jnp.sqrt((rp ** 2).sum(-1)), 1e-8), 0.0)
        occ = jnp.where(dist_z > surface_eps,
                        jnp.clip((fade_end - dist_z) / fade_len, 0.0, 1.0),
                        0.0)
        occlusion_sum = occlusion_sum + dp * occ

    access = 1.0 - occlusion_sum / offsets.shape[0]
    return jnp.clip(access, 0.0, 1.0) ** 6


def bilateral_blur(ambient, normal_v, depth_view, weights, horizontal: bool,
                   border_depth_view: float = None):
    """SsaoBlur.hlsl PS: radius-5 separable Gaussian with edge stopping
    (reject neighbor if dot(normals) < 0.8 or |view depth diff| > 0.2),
    renormalized by accepted weight.

    border_depth_view: the view depth a neighbor tap reads PAST the screen
    edge. The reference samples depth with gsamDepthMap (border
    OPAQUE_WHITE), so off-screen neighbors read NDC depth 1.0 -> the far
    plane's view depth and are rejected by the 0.2 depth stop; ambient and
    normals use pointClamp (edge clamp) as before. None keeps the old
    clamp-to-edge depth (pre-parity behavior, unit tests only).
    """
    radius = (len(weights) - 1) // 2
    axis = 1 if horizontal else 0
    acc = weights[radius] * ambient
    total = jnp.full_like(ambient, weights[radius])
    n_c = normal_v
    d_c = depth_view
    n = ambient.shape[axis]
    for i in range(-radius, radius + 1):
        if i == 0:
            continue
        a_n = _shift_clamp(ambient, i, axis)
        n_n = _shift_clamp(normal_v, i, axis)
        d_n = _shift_clamp(depth_view, i, axis)
        if border_depth_view is not None:
            off = (jnp.arange(n) + i < 0) | (jnp.arange(n) + i >= n)
            off = off[:, None] if axis == 0 else off[None, :]
            d_n = jnp.where(off, jnp.asarray(border_depth_view,
                                             d_n.dtype), d_n)
        ok = (((n_n * n_c).sum(-1) >= 0.8)
              & (jnp.abs(d_n - d_c) <= 0.2)).astype(ambient.dtype)
        wgt = weights[i + radius] * ok
        acc = acc + wgt * a_n
        total = total + wgt
    return acc / total


def _shift_clamp(img, offset, axis):
    """Shift with clamp-to-edge (the blur samples with pointClamp)."""
    n = img.shape[axis]
    idx = jnp.clip(jnp.arange(n) + offset, 0, n - 1)
    return jnp.take(img, idx, axis=axis)
