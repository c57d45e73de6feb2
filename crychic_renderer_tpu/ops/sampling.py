"""Texture sampling: the (diffuse, normal) pair pool with quad rows and
dual-mip rows, anisotropic probe schedules, and cubemap sampling.

Replaces the D3D12 sampler hardware used by the reference's shaders
(gsamAnisotropicWrap / gsamLinearClamp / gsamLinearWrap, static samplers
at /root/reference/CRYCHIC.cpp:2601). Sampling here is gathers, and the
pool is shaped to minimize gathered row count: one row
carries the 2x2 bilinear quads of BOTH maps a G-buffer pixel samples
(PairPool), and optionally of both mip levels a trilinear blend needs
(dual-mip rows) — one gather per bilinear/trilinear sample, one per
anisotropic probe.

Filtering parity: D3D12_FILTER_ANISOTROPIC (MaxAnisotropy=8) is
approximated by a probe schedule whose quality is QUANTIFIED against the
16-gather reference evaluation (sample_pair_aniso_ref); deviations
concentrate at grazing angles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

# Two-class pool geometry: "big" textures (material maps) are stored at
# POOL_SIZE^2 with full mip chains; "small" textures (the 64x64 animation
# frames) at POOL_SIZE_SMALL^2 — otherwise upsampling them to 512^2 blows
# the pool's size and cache footprint. Class
# membership is by index (big textures first), so per-pixel addressing
# stays fully ANALYTIC: a compare + two shift formulas, zero metadata
# gathers.
POOL_SIZE = 512
POOL_MIPS = 10  # 512 .. 1
POOL_SIZE_SMALL = 64
POOL_MIPS_SMALL = 7  # 64 .. 1


def _mip_offset(mip):
    """Flat texel offset of mip level `mip` within one big-class chain:
    sum_{k<m} (512>>k)^2 = (4^10 - 4^(10-m)) / 3."""
    return (1048576 - (1 << (20 - 2 * mip))) // 3


def _mip_offset_small(mip):
    """sum_{k<m} (64>>k)^2 = (4^7 - 4^(7-m)) / 3."""
    return (16384 - (1 << (14 - 2 * mip))) // 3


TEX_STRIDE = _mip_offset(POOL_MIPS)  # texels per big chain
TEX_STRIDE_SMALL = _mip_offset_small(POOL_MIPS_SMALL)


def _mip_offset_dyn(mip):
    return (1048576 - (jnp.int32(1) << (20 - 2 * mip))) // 3


def _mip_offset_small_dyn(mip):
    return (16384 - (jnp.int32(1) << (14 - 2 * mip))) // 3


def unpack_rgba8(packed: jnp.ndarray) -> jnp.ndarray:
    """(…,) uint32 -> (…, 4) float32 in [0, 1]."""
    p = packed
    r = (p & 0xFF).astype(jnp.float32)
    g = ((p >> 8) & 0xFF).astype(jnp.float32)
    b = ((p >> 16) & 0xFF).astype(jnp.float32)
    a = ((p >> 24) & 0xFF).astype(jnp.float32)
    return jnp.stack([r, g, b, a], axis=-1) * (1.0 / 255.0)


# ---------------------------------------------------------------------------
# Paired pool: the frame's hot path
# ---------------------------------------------------------------------------
# Every G-buffer pixel samples its material's diffuse AND normal map at the
# SAME uv and lod (GeometryPass.hlsl:52-55), so the two textures are packed
# side by side in one row: row(pair, mip, y, x) = [diffuse 2x2 quad | normal
# 2x2 quad], 8 uint32 = 32 bytes. One gather fetches a bilinear footprint of
# BOTH maps; trilinear is two (mip m, m+1): half the gathered rows of
# separate maps. Pairs are deduplicated by (diffuse, normal) texture
# ids; animated materials get one (small-class) pair per animation frame.

PAIR_ROW = 8       # u32 lanes per single-mip pair row
PAIR_ROW_DUAL = 16  # u32 lanes per dual-mip pair row


@dataclasses.dataclass
class PairPool:
    """data: (rows, 8 | 16) uint32; pairs [0, n_big) are POOL_SIZE^2
    chains of POOL_MIPS levels, the rest POOL_SIZE_SMALL^2 /
    POOL_MIPS_SMALL.

    Dual-mip rows (dual=True, lanes 8:16): the row for (pair, mip m,
    y, x) additionally carries the mip-(m+1) quads of parent texel
    (y>>1, x>>1) — [diff_m | nrm_m | diff_m+1 | nrm_m+1]. A trilinear
    sample then needs ONE row gather instead of two, and every aniso
    probe gets a full (exact-m, near-exact m+1) mip blend from its single
    gather. The m+1 bilinear evaluated from the midpoint-parent quad is
    exact except when the child texel is even AND the parent frac is in
    [-0.25, 0): there the quad linearly extrapolates by <= 0.25 texel,
    bounded by 0.25x the parent mip's second difference (box-filtered
    mips are smooth; measured delta on the golden scenes is < 1 u8 step).
    The last level stores itself as parent (its blend weight is 0)."""

    data: jnp.ndarray
    n_big: int
    dual: bool = False

    @staticmethod
    def build(pair_chains, n_big: int, dual: bool = False) -> "PairPool":
        """pair_chains: list of (diffuse_mips, normal_mips) where each is a
        list of (H, W, 4) uint8 mip levels; pairs [0, n_big) are resampled
        to the big class, the rest to the small class."""
        chunks = []
        for pi, (dmips, nmips) in enumerate(pair_chains):
            size = POOL_SIZE if pi < n_big else POOL_SIZE_SMALL
            levels = POOL_MIPS if pi < n_big else POOL_MIPS_SMALL
            dchain = _resample_chain(dmips, size, levels)
            nchain = _resample_chain(nmips, size, levels)
            for level in range(levels):
                dq = _quad_pack_wrap(dchain[level])
                nq = _quad_pack_wrap(nchain[level])
                row = [dq.reshape(-1, 4), nq.reshape(-1, 4)]
                if dual:
                    lp = min(level + 1, levels - 1)
                    s = dchain[level].shape[0]
                    dp = _parent_quads(dchain[lp], s, level != lp)
                    npq = _parent_quads(nchain[lp], s, level != lp)
                    row += [dp.reshape(-1, 4), npq.reshape(-1, 4)]
                chunks.append(np.concatenate(row, axis=-1))
        data = np.concatenate(chunks, axis=0)
        return PairPool(data=jnp.asarray(data), n_big=int(n_big),
                        dual=bool(dual))


def _parent_quads(parent_level: np.ndarray, child_size: int,
                  is_real_parent: bool) -> np.ndarray:
    """(S1, S1, 4) uint8 parent mip -> (child_size, child_size, 4) uint32:
    for each child texel (y, x), the parent's wrap-quad at (y>>1, x>>1).
    When the child is the last level the 'parent' is itself (quad
    repeated), kept only so the row layout is uniform."""
    q = _quad_pack_wrap(parent_level)  # (S1, S1, 4)
    if not is_real_parent:
        return q[:child_size, :child_size]
    return np.repeat(np.repeat(q, 2, axis=0), 2, axis=1)[:child_size,
                                                         :child_size]


def _resample_chain(mips, size: int, levels: int):
    """Resample a mip chain so level 0 is (size, size); regenerate the
    chain down to 1x1 by box filtering."""
    from ..io.dds import generate_mips

    img = mips[0]
    h, w = img.shape[:2]
    if (h, w) != (size, size):
        if h > size or w > size:  # downsample via mip chain
            chain0 = generate_mips(img)
            for m in chain0:
                if max(m.shape[:2]) <= size:
                    img = m
                    break
            h, w = img.shape[:2]
        ry = max(size // max(h, 1), 1)
        rx = max(size // max(w, 1), 1)
        img = np.repeat(np.repeat(img, ry, axis=0), rx, axis=1)
        img = img[:size, :size]
        if img.shape[0] < size or img.shape[1] < size:
            img = np.pad(img, ((0, size - img.shape[0]),
                               (0, size - img.shape[1]),
                               (0, 0)), mode="edge")
    chain = generate_mips(img)[:levels]
    while len(chain) < levels:
        chain.append(chain[-1])
    return chain


def _quad_pack_wrap(m: np.ndarray) -> np.ndarray:
    """(S, S, 4) uint8 -> (S, S, 4) uint32: per texel, its WRAP-addressed
    2x2 neighborhood quad, each RGBA8-packed."""
    u = m.astype(np.uint32)
    packed = (u[..., 0] | (u[..., 1] << 8)
              | (u[..., 2] << 16) | (u[..., 3] << 24))
    xp = np.roll(packed, -1, axis=1)
    yp = np.roll(packed, -1, axis=0)
    xyp = np.roll(xp, -1, axis=0)
    return np.stack([packed, xp, yp, xyp], axis=-1)


def _pair_row_offset(pool: PairPool, pair, mip_b, mip_s):
    """Flat row index of (pair, mip) chain starts (analytic two-class
    addressing: big pairs first, then small; no metadata gathers)."""
    is_big = pair < pool.n_big
    small_base = pool.n_big * TEX_STRIDE
    return jnp.where(
        is_big, pair * TEX_STRIDE + _mip_offset_dyn(mip_b),
        small_base + (pair - pool.n_big) * TEX_STRIDE_SMALL
        + _mip_offset_small_dyn(mip_s))


def sample_pair_bilinear(pool: PairPool, pair: jnp.ndarray,
                         uv: jnp.ndarray, mip: jnp.ndarray):
    """One bilinear fetch of both maps: ONE row gather per sample.

    pair/mip: (...,) int32; uv: (..., 2). Returns (diffuse, normal), each
    (..., 4) float32. WRAP addressing (the reference samples material maps
    with the Wrap samplers)."""
    is_big = pair < pool.n_big
    mip_b = jnp.clip(mip, 0, POOL_MIPS - 1)
    mip_s = jnp.clip(mip, 0, POOL_MIPS_SMALL - 1)
    size = jnp.where(is_big, jnp.int32(POOL_SIZE) >> mip_b,
                     jnp.int32(POOL_SIZE_SMALL) >> mip_s)
    fsize = size.astype(jnp.float32)
    x = uv[..., 0] * fsize - 0.5
    y = uv[..., 1] * fsize - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xa = jnp.remainder(x0.astype(jnp.int32), size)
    ya = jnp.remainder(y0.astype(jnp.int32), size)
    off = _pair_row_offset(pool, pair, mip_b, mip_s)
    row = pool.data[off + ya * size + xa]  # (..., 8) u32 — ONE gather

    def bilerp(quad):
        c00 = unpack_rgba8(quad[..., 0])
        c10 = unpack_rgba8(quad[..., 1])
        c01 = unpack_rgba8(quad[..., 2])
        c11 = unpack_rgba8(quad[..., 3])
        top = c00 * (1 - fx) + c10 * fx
        bot = c01 * (1 - fx) + c11 * fx
        return top * (1 - fy) + bot * fy

    return bilerp(row[..., 0:4]), bilerp(row[..., 4:8])


def _bilerp_quad(quad, fx, fy):
    c00 = unpack_rgba8(quad[..., 0])
    c10 = unpack_rgba8(quad[..., 1])
    c01 = unpack_rgba8(quad[..., 2])
    c11 = unpack_rgba8(quad[..., 3])
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_pair_dual(pool: PairPool, pair: jnp.ndarray, uv: jnp.ndarray,
                     mip: jnp.ndarray, f: jnp.ndarray):
    """ONE row gather -> the full trilinear blend of both maps.

    Requires a dual-mip pool (PairPool.build(dual=True)). mip: (...,)
    int32 floor level; f: (...,) float32 blend toward mip+1. Returns
    (diffuse, normal), each (..., 4).

    The mip-m bilinear is exact; the mip-(m+1) bilinear comes from the
    midpoint-parent quad stored in the row (see PairPool: fractional
    parent coordinate fx1 = fx/2 - 0.25 + 0.5*(x0 odd), which
    extrapolates by <= 0.25 texel on even child texels)."""
    is_big = pair < pool.n_big
    mip_b = jnp.clip(mip, 0, POOL_MIPS - 1)
    mip_s = jnp.clip(mip, 0, POOL_MIPS_SMALL - 1)
    size = jnp.where(is_big, jnp.int32(POOL_SIZE) >> mip_b,
                     jnp.int32(POOL_SIZE_SMALL) >> mip_s)
    fsize = size.astype(jnp.float32)
    x = uv[..., 0] * fsize - 0.5
    y = uv[..., 1] * fsize - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xa = jnp.remainder(x0.astype(jnp.int32), size)
    ya = jnp.remainder(y0.astype(jnp.int32), size)
    off = _pair_row_offset(pool, pair, mip_b, mip_s)
    row = pool.data[off + ya * size + xa]  # (..., 16) u32 — ONE gather

    d0 = _bilerp_quad(row[..., 0:4], fx, fy)
    n0 = _bilerp_quad(row[..., 4:8], fx, fy)
    fx1 = 0.5 * fx - 0.25 + 0.5 * (xa & 1).astype(jnp.float32)[..., None]
    fy1 = 0.5 * fy - 0.25 + 0.5 * (ya & 1).astype(jnp.float32)[..., None]
    # the parent-quad extrapolation (fx1/fy1 in [-0.25, 0)) can leave
    # [0, 1] by a hair; the TRUE bilinear of UNORM texels never does, so
    # clamping strictly reduces the (bounded) extrapolation error — and
    # keeps consumers like Default.hlsl's shininess = (1-rough)*alpha from
    # seeing a negative alpha (pow(0, negative) = inf -> NaN pixels)
    d1 = jnp.clip(_bilerp_quad(row[..., 8:12], fx1, fy1), 0.0, 1.0)
    n1 = jnp.clip(_bilerp_quad(row[..., 12:16], fx1, fy1), 0.0, 1.0)
    fb = f[..., None]
    return d0 * (1 - fb) + d1 * fb, n0 * (1 - fb) + n1 * fb


def class_lod(pool: PairPool, pair: jnp.ndarray, lod_uv: jnp.ndarray):
    """uv-space lod (log2 of the uv footprint) -> mip level for the pair's
    own class. This is the small-class LOD fix: a 64^2 chain at 1:1 screen
    scale must sample mip 0, not mip 3."""
    is_big = pair < pool.n_big
    bits = jnp.where(is_big, float(np.log2(POOL_SIZE)),
                     float(np.log2(POOL_SIZE_SMALL)))
    max_mip = jnp.where(is_big, POOL_MIPS - 1.0, POOL_MIPS_SMALL - 1.0)
    return jnp.clip(lod_uv + bits, 0.0, max_mip)


def sample_pair_trilinear(pool: PairPool, pair: jnp.ndarray,
                          uv: jnp.ndarray, lod_uv: jnp.ndarray):
    """Trilinear fetch of both maps: ONE row gather on a dual-mip pool,
    two on a single-mip pool. lod_uv is the uv-space footprint log2 (see
    class_lod)."""
    lod = class_lod(pool, pair, lod_uv)
    m0 = jnp.floor(lod).astype(jnp.int32)
    f = lod - m0.astype(jnp.float32)
    if pool.dual:
        return sample_pair_dual(pool, pair, uv, m0, f)
    m1 = m0 + 1  # clipped per class inside sample_pair_bilinear
    d0, n0 = sample_pair_bilinear(pool, pair, uv, m0)
    d1, n1 = sample_pair_bilinear(pool, pair, uv, m1)
    fb = f[..., None]
    return d0 * (1 - fb) + d1 * fb, n0 * (1 - fb) + n1 * fb


def uv_derivatives(uv: jnp.ndarray):
    """Screen-space uv derivatives of a (H, W, 2) uv image by finite
    differences — the software analogue of pixel-quad derivatives. Edges
    reuse their neighbor's derivative (like HW helper lanes)."""
    dx = jnp.diff(uv, axis=1, append=uv[:, -1:, :])
    dx = dx.at[:, -1, :].set(dx[:, -2, :])
    dy = jnp.diff(uv, axis=0, append=uv[-1:, :, :])
    dy = dy.at[-1, :, :].set(dy[-2, :, :])
    return dx, dy


def lod_from_derivatives(dx: jnp.ndarray, dy: jnp.ndarray):
    """Isotropic (trilinear) uv-space lod: log2 of the larger footprint."""
    rho = jnp.maximum(jnp.sqrt((dx * dx).sum(-1)),
                      jnp.sqrt((dy * dy).sum(-1)))
    return jnp.log2(jnp.maximum(rho, 1e-12))


def sample_pair_aniso(pool: PairPool, pair: jnp.ndarray, uv: jnp.ndarray,
                      dx: jnp.ndarray, dy: jnp.ndarray, max_aniso: int,
                      probes: int = 4):
    """Anisotropic filtering of both maps (D3D12_FILTER_ANISOTROPIC with
    MaxAnisotropy=8 — the reference's gsamAnisotropicWrap static sampler,
    /root/reference/CRYCHIC.cpp:2631-2645).

    Standard footprint decomposition (EXT_texture_filter_anisotropic):
    M = min(ceil(p_max / p_min), max_aniso) probes spaced along the
    major-axis uv derivative, at lod = log2(p_max / M).

    Cost shaping: each probe is ONE row gather (gathers are the whole
    cost of texturing here), so instead of 2 gathers per probe for the
    trilinear mip blend, a static loop of ``probes`` probes ALTERNATES
    between mip m0 and m1 with weights (1-f) / f — the mip blend and the
    line footprint are sampled jointly (D3D12 leaves the probe schedule
    implementation-defined). When the footprint is isotropic, consecutive
    probes collapse to the same uv and the result is EXACT trilinear.
    Active-probe masking is dense (no data-dependent control flow).
    """
    lx2 = (dx * dx).sum(-1)
    ly2 = (dy * dy).sum(-1)
    major_is_x = lx2 >= ly2
    p_max = jnp.sqrt(jnp.maximum(jnp.maximum(lx2, ly2), 1e-24))
    p_min = jnp.sqrt(jnp.maximum(jnp.minimum(lx2, ly2), 1e-24))
    ratio = jnp.clip(p_max / p_min, 1.0, float(max_aniso))
    M = jnp.minimum(jnp.ceil(ratio - 1e-4), float(probes))
    lod_uv = jnp.log2(p_max / M)
    duv = jnp.where(major_is_x[..., None], dx, dy)  # (..., 2) major axis

    lod = class_lod(pool, pair, lod_uv)
    m0 = jnp.floor(lod).astype(jnp.int32)
    m1 = m0 + 1
    f = lod - m0.astype(jnp.float32)

    if pool.dual:
        # every probe gets the FULL trilinear blend from its single row
        # gather (sample_pair_dual), so the schedule is purely spatial:
        # M <= probes slots spread along the major axis. P dual probes
        # sample the line footprint at the same gather cost as P/2
        # single-mip probes did, with an exact per-probe mip blend.
        d_acc = 0.0
        n_acc = 0.0
        w_acc = 0.0
        for i in range(probes):
            j = jnp.minimum(jnp.float32(i), M - 1.0)
            j = jnp.where(jnp.float32(i) >= M, jnp.float32(i) - M, j)
            s = ((j + 0.5) / M - 0.5) * ((M - 1.0) / M)
            puv = uv + duv * s[..., None]
            active = (jnp.float32(i) < M).astype(jnp.float32)
            d, n = sample_pair_dual(pool, pair, puv, m0, f)
            wgt = active[..., None]
            d_acc = d_acc + wgt * d
            n_acc = n_acc + wgt * n
            w_acc = w_acc + wgt
        w_acc = jnp.maximum(w_acc, 1e-8)
        return d_acc / w_acc, n_acc / w_acc

    # probe i: position index j = i // 2 of ceil(M/2) slots when blending
    # both mips... simpler uniform schedule: position slot j_i spreads the
    # ACTIVE count M over the footprint; scale (M-1)/M makes M=1 collapse
    # to the center (exact trilinear for isotropic pixels).
    d_acc = 0.0
    n_acc = 0.0
    w_acc = 0.0
    for i in range(probes):
        # slot within the active probes (wraps if probes > M)
        j = jnp.minimum(jnp.float32(i), M - 1.0)
        j = jnp.where(jnp.float32(i) >= M,
                      jnp.float32(i) - M, j)  # wrap: reuse early slots
        s = ((j + 0.5) / M - 0.5) * ((M - 1.0) / M)
        puv = uv + duv * s[..., None]
        use_m1 = (i % 2) == 1
        mip = m1 if use_m1 else m0
        w = (f if use_m1 else (1.0 - f))
        # with a single active probe pair, probe 1 must still contribute
        # the m1 term; probes beyond 2*M duplicate earlier slots and get
        # folded into the normalization
        active = jnp.float32(1.0) * (jnp.float32(i) < jnp.maximum(
            2.0 * M, 2.0)) * (jnp.float32(i) < float(probes))
        d, n = sample_pair_bilinear(pool, pair, puv, mip)
        wgt = (w * active)[..., None]
        d_acc = d_acc + wgt * d
        n_acc = n_acc + wgt * n
        w_acc = w_acc + wgt
    w_acc = jnp.maximum(w_acc, 1e-8)
    return d_acc / w_acc, n_acc / w_acc


def sample_pair_aniso_ref(pool: PairPool, pair: jnp.ndarray,
                          uv: jnp.ndarray, dx: jnp.ndarray,
                          dy: jnp.ndarray, max_aniso: int):
    """REFERENCE-QUALITY anisotropic evaluation: max_aniso probes, each an
    exact two-gather trilinear — the quality bar D3D12_FILTER_ANISOTROPIC
    hardware meets or beats. 2*max_aniso row gathers per pixel: far too
    slow for the frame path; used by tests and experiments to QUANTIFY
    the production probe schedules."""
    lx2 = (dx * dx).sum(-1)
    ly2 = (dy * dy).sum(-1)
    major_is_x = lx2 >= ly2
    p_max = jnp.sqrt(jnp.maximum(jnp.maximum(lx2, ly2), 1e-24))
    p_min = jnp.sqrt(jnp.maximum(jnp.minimum(lx2, ly2), 1e-24))
    ratio = jnp.clip(p_max / p_min, 1.0, float(max_aniso))
    M = jnp.ceil(ratio - 1e-4)
    lod_uv = jnp.log2(p_max / M)
    duv = jnp.where(major_is_x[..., None], dx, dy)

    lod = class_lod(pool, pair, lod_uv)
    m0 = jnp.floor(lod).astype(jnp.int32)
    f = (lod - m0.astype(jnp.float32))[..., None]
    d_acc = 0.0
    n_acc = 0.0
    w_acc = 0.0
    for i in range(max_aniso):
        s = ((jnp.float32(i) + 0.5) / M - 0.5) * ((M - 1.0) / M)
        puv = uv + duv * s[..., None]
        active = (jnp.float32(i) < M).astype(jnp.float32)[..., None]
        d0, n0 = sample_pair_bilinear(pool, pair, puv, m0)
        d1, n1 = sample_pair_bilinear(pool, pair, puv, m0 + 1)
        d_acc = d_acc + active * (d0 * (1 - f) + d1 * f)
        n_acc = n_acc + active * (n0 * (1 - f) + n1 * f)
        w_acc = w_acc + active
    w_acc = jnp.maximum(w_acc, 1e-8)
    return d_acc / w_acc, n_acc / w_acc


# ---------------------------------------------------------------------------
# Cubemap
# ---------------------------------------------------------------------------

def pack_cubemap(faces: np.ndarray) -> np.ndarray:
    """(6, S, S, 4) float [0,1] -> (6, S, S, 4) uint32: per texel, the
    clamp-addressed 2x2 neighborhood quad, RGBA8-packed — one row gather
    per bilinear cubemap sample."""
    u = np.clip(np.asarray(faces) * 255.0 + 0.5, 0, 255).astype(np.uint32)
    packed = (u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
              | (u[..., 3] << 24))  # (6, S, S)
    xp = packed[:, :, np.minimum(np.arange(packed.shape[2]) + 1,
                                 packed.shape[2] - 1)]
    yp = packed[:, np.minimum(np.arange(packed.shape[1]) + 1,
                              packed.shape[1] - 1), :]
    xyp = yp[:, :, np.minimum(np.arange(packed.shape[2]) + 1,
                              packed.shape[2] - 1)]
    return np.stack([packed, xp, yp, xyp], axis=-1)


def sample_cubemap(faces: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """faces: (6, S, S) uint32 RGBA8-packed in D3D face order
    (+X -X +Y -Y +Z -Z); direction: (..., 3). Bilinear within the face,
    edges clamped."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    # major axis selection (D3D TextureCube convention)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    is_z = ~(is_x | is_y)
    face = jnp.where(
        is_x, jnp.where(x >= 0, 0, 1),
        jnp.where(is_y, jnp.where(y >= 0, 2, 3), jnp.where(z >= 0, 4, 5)),
    ).astype(jnp.int32)
    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    ma = jnp.maximum(ma, 1e-20)
    sc = jnp.where(
        is_x, jnp.where(x >= 0, -z, z),
        jnp.where(is_y, x, jnp.where(z >= 0, x, -x)),
    )
    tc = jnp.where(is_y, jnp.where(y >= 0, z, -z), -y)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)

    S = faces.shape[1]
    fx = u * S - 0.5
    fy = v * S - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, S - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, S - 1)
    quad = faces[face, y0i, x0i]  # (..., 4) u32 — ONE gather
    c00 = unpack_rgba8(quad[..., 0])
    c10 = unpack_rgba8(quad[..., 1])
    c01 = unpack_rgba8(quad[..., 2])
    c11 = unpack_rgba8(quad[..., 3])
    top = c00 * (1 - wx) + c10 * wx
    bot = c01 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy


SKY_ZENITH = (0.18, 0.32, 0.65)
SKY_HORIZON = (0.82, 0.88, 0.95)
SKY_GROUND = (0.35, 0.33, 0.30)


def procedural_sky_color(direction: jnp.ndarray) -> jnp.ndarray:
    """Analytic evaluation of the procedural sky (the same function
    procedural_sky_cubemap discretizes into faces): direction (..., 3)
    -> (..., 3) color. ZERO gathers — a cubemap fetch costs one row
    gather per pixel while this is pure arithmetic, so the frame path
    evaluates the substitute sky directly and keeps sample_cubemap for
    file-loaded cubemaps."""
    d = direction / jnp.maximum(
        jnp.sqrt((direction ** 2).sum(-1, keepdims=True)), 1e-20)
    h = d[..., 1:2]
    t = jnp.clip(h, 0.0, 1.0) ** 0.6
    zenith = jnp.asarray(SKY_ZENITH, jnp.float32)
    horizon = jnp.asarray(SKY_HORIZON, jnp.float32)
    ground = jnp.asarray(SKY_GROUND, jnp.float32)
    sky = horizon * (1.0 - t) + zenith * t
    g = jnp.clip(-h, 0.0, 1.0) ** 0.5
    return sky * (1.0 - g) + ground * g


def procedural_sky_cubemap(size: int = 256) -> np.ndarray:
    """Substitute for the missing snowcube1024.dds asset
    (LoadTextures requests it, CRYCHIC.cpp:960, but the repo ships no
    cubemap — SURVEY.md §0). A horizon-graded sky: deep blue zenith,
    pale horizon, dark ground."""
    S = size
    faces = np.zeros((6, S, S, 4), dtype=np.float32)
    uv = (np.arange(S, dtype=np.float32) + 0.5) / S * 2.0 - 1.0
    u, v = np.meshgrid(uv, uv, indexing="xy")
    dirs = {
        0: lambda u, v: np.stack([np.ones_like(u), -v, -u], -1),
        1: lambda u, v: np.stack([-np.ones_like(u), -v, u], -1),
        2: lambda u, v: np.stack([u, np.ones_like(u), v], -1),
        3: lambda u, v: np.stack([u, -np.ones_like(u), -v], -1),
        4: lambda u, v: np.stack([u, -v, np.ones_like(u)], -1),
        5: lambda u, v: np.stack([-u, -v, -np.ones_like(u)], -1),
    }
    zenith = np.array(SKY_ZENITH)
    horizon = np.array(SKY_HORIZON)
    ground = np.array(SKY_GROUND)
    for f in range(6):
        d = dirs[f](u, v)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        h = d[..., 1]
        t = np.clip(h, 0.0, 1.0) ** 0.6
        sky = horizon * (1 - t[..., None]) + zenith * t[..., None]
        g = np.clip(-h, 0.0, 1.0) ** 0.5
        col = sky * (1 - g[..., None]) + ground * g[..., None]
        faces[f, ..., :3] = col
        faces[f, ..., 3] = 1.0
    return faces
