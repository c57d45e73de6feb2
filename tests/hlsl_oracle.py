"""Independent scalar transliteration of the reference HLSL shading math.

Written LINE-BY-LINE from the reference shaders (cited per function) and
kept textually close to the HLSL — deliberately slow, scalar, and sharing
NOTHING with crychic_renderer_tpu.ops. tests/test_hlsl_oracle.py evaluates
this oracle at ~1k random pixel configurations against the production
(vectorized, gather-shaped) implementations, so a transcription error in ops/
(a swapped BRDF coefficient, a wrong fade constant) fails loudly even
though every golden image in the repo is self-blessed.

HLSL semantics notes:
- float3 -> np.array(3, float32); mul(v, M) is row-vector v @ M.
- frac(x) = x - floor(x); rcp is exact division here (fxc emits a real
  divide for these shaders at default optimization).
- `5 / width` in CalcCascadeShadowFactorWithPoisson is INT / UINT ->
  integer division (HLSL arithmetic conversion): 0 for any real map size.
  See oracle_search_radius below; this is load-bearing (the reference's
  Poisson disk radius is ZERO as compiled, so the filter collapses to one
  comparison tap repeated 16 times).
"""
from __future__ import annotations

import dataclasses

import numpy as np

f32 = np.float32


def saturate(x):
    return np.minimum(np.maximum(x, f32(0.0)), f32(1.0))


def lerp(a, b, t):
    return a + (b - a) * t


def frac(x):
    return x - np.floor(x)


def normalize(v):
    return v / np.sqrt((v * v).sum())


def dot(a, b):
    return f32((np.asarray(a, f32) * np.asarray(b, f32)).sum())


def reflect(i, n):
    # HLSL intrinsic: i - 2 * dot(i, n) * n
    return i - f32(2.0) * dot(i, n) * n


def sign(x):
    return f32(np.sign(x))


# ---------------------------------------------------------------------------
# LightingUtil.hlsl
# ---------------------------------------------------------------------------

MaxLights = 16  # LightingUtil.hlsl:7


@dataclasses.dataclass
class Light:
    """LightingUtil.hlsl:9-17."""
    Strength: np.ndarray
    FalloffStart: float
    Direction: np.ndarray
    FalloffEnd: float
    Position: np.ndarray
    SpotPower: float


@dataclasses.dataclass
class Material:
    """LightingUtil.hlsl:35-42."""
    DiffuseAlbedo: np.ndarray  # float4
    FresnelR0: np.ndarray      # float3
    Roughness: float
    Metalness: float
    Shininess: float


def CalcAttenuation(d, falloffStart, falloffEnd):
    """LightingUtil.hlsl:44-48."""
    return saturate((falloffEnd - d) / (falloffEnd - falloffStart))


def SchlickFresnel(R0, normal, lightVec):
    """LightingUtil.hlsl:52-60."""
    cosIncidentAngle = saturate(dot(normal, lightVec))
    f0 = f32(1.0) - cosIncidentAngle
    reflectPercent = R0 + (f32(1.0) - R0) * (f0 * f0 * f0 * f0 * f0)
    return reflectPercent


def BlinnPhong(lightStrength, lightVec, normal, toEye, mat: Material):
    """LightingUtil.hlsl:62-77."""
    m = mat.Shininess * f32(256.0)
    halfVec = normalize(toEye + lightVec)
    roughnessFactor = ((m + f32(8.0))
                       * np.power(max(dot(halfVec, normal), f32(0.0)), m)
                       / f32(8.0))
    fresnelFactor = SchlickFresnel(mat.FresnelR0, halfVec, lightVec)
    specAlbedo = fresnelFactor * roughnessFactor
    specAlbedo = specAlbedo / (specAlbedo + f32(1.0))
    return (mat.DiffuseAlbedo[:3] + specAlbedo) * lightStrength


def ComputeDirectionalLight(L: Light, mat: Material, normal, toEye):
    """LightingUtil.hlsl:82-93."""
    lightVec = -L.Direction
    ndotl = max(dot(lightVec, normal), f32(0.0))
    lightStrength = L.Strength * ndotl
    return BlinnPhong(lightStrength, lightVec, normal, toEye, mat)


def ComputePointLight(L: Light, mat: Material, pos, normal, toEye):
    """LightingUtil.hlsl:98-122."""
    lightVec = L.Position - pos
    d = f32(np.sqrt((lightVec * lightVec).sum()))
    if d > L.FalloffEnd:
        return np.zeros(3, f32)
    lightVec = lightVec / d
    ndotl = max(dot(lightVec, normal), f32(0.0))
    lightStrength = L.Strength * ndotl
    att = CalcAttenuation(d, L.FalloffStart, L.FalloffEnd)
    lightStrength = lightStrength * att
    return BlinnPhong(lightStrength, lightVec, normal, toEye, mat)


def ComputeSpotLight(L: Light, mat: Material, pos, normal, toEye):
    """LightingUtil.hlsl:127-154."""
    lightVec = L.Position - pos
    d = f32(np.sqrt((lightVec * lightVec).sum()))
    if d > L.FalloffEnd:
        return np.zeros(3, f32)
    lightVec = lightVec / d
    ndotl = max(dot(lightVec, normal), f32(0.0))
    lightStrength = L.Strength * ndotl
    att = CalcAttenuation(d, L.FalloffStart, L.FalloffEnd)
    lightStrength = lightStrength * att
    spotFactor = np.power(max(dot(-lightVec, L.Direction), f32(0.0)),
                          L.SpotPower)
    lightStrength = lightStrength * spotFactor
    return BlinnPhong(lightStrength, lightVec, normal, toEye, mat)


def ComputeLighting(gLights, mat: Material, pos, normal, toEye,
                    shadowFactor, num_dir, num_point, num_spot):
    """LightingUtil.hlsl:156-186 (the NUM_*_LIGHTS #if blocks become
    python range bounds)."""
    result = np.zeros(3, f32)
    for i in range(0, num_dir):
        result = result + shadowFactor[i] * ComputeDirectionalLight(
            gLights[i], mat, normal, toEye)
    for i in range(num_dir, num_dir + num_point):
        result = result + ComputePointLight(gLights[i], mat, pos, normal,
                                            toEye)
    for i in range(num_dir + num_point, num_dir + num_point + num_spot):
        result = result + ComputeSpotLight(gLights[i], mat, pos, normal,
                                           toEye)
    return result  # float4(result, 0.0f).rgb


# ---------------------------------------------------------------------------
# PBR.hlsl
# ---------------------------------------------------------------------------

pi = f32(3.1415926)  # PBR.hlsl:2


@dataclasses.dataclass
class PBRDesc:
    """LightingUtil.hlsl:19-33."""
    normal: np.ndarray = None
    pos: np.ndarray = None
    halfVec: np.ndarray = None
    lightDir: np.ndarray = None
    view: np.ndarray = None
    roughness: float = 0.0
    metalness: float = 0.0
    diffuseAlbedo: np.ndarray = None
    hDotv: float = 0.0
    nDotl: float = 0.0
    nDotv: float = 0.0


def NDF_GGX(normal, halfVec, a):
    """PBR.hlsl:4-14."""
    a2 = a * a
    nDoth = max(dot(normal, halfVec), f32(0.001))
    nDoth2 = nDoth * nDoth
    top = a2
    tmp = np.power(nDoth2 * (a2 - f32(1.0)) + f32(1.0), f32(2.0))
    bottom = pi * tmp
    return top / bottom  # rcp


def GeometrySchlickGGX(nDotvec, k):
    """PBR.hlsl:16-21."""
    top = nDotvec
    bottom = nDotvec * (f32(1.0) - k) + k
    return top / bottom


def GeometrySmith(pbrDesc: PBRDesc):
    """PBR.hlsl:28-38."""
    nDotv = pbrDesc.nDotv
    nDotl = pbrDesc.nDotl
    roughness = pbrDesc.roughness
    k = f32(0.125) * (roughness + f32(1.0)) * (roughness + f32(1.0))
    ggx1 = GeometrySchlickGGX(nDotv, k)
    ggx2 = GeometrySchlickGGX(nDotl, k)
    return ggx1 * ggx2


def FresnelSchlick(hDotv, f0):
    """PBR.hlsl:40-43."""
    return f0 + (f32(1.0) - f0) * np.power(
        np.clip(f32(1.0) - hDotv, f32(0.0), f32(1.0)), f32(5.0))


def GetBRDF(pbrDesc: PBRDesc):
    """PBR.hlsl:45-70 — transcribed with its quirks intact:
    `float nDotv = pbrDesc.hDotv;` (:58) makes the Fresnel cosine AND the
    specular denominator use h.v where n.v was intended; GeometrySmith
    still reads the true nDotv from the desc."""
    normal = pbrDesc.normal
    halfVec = pbrDesc.halfVec
    diffuseAlbedo = pbrDesc.diffuseAlbedo
    roughness = pbrDesc.roughness
    metalness = pbrDesc.metalness
    f0 = lerp(f32(0.04), diffuseAlbedo, metalness)
    nDotl = pbrDesc.nDotl
    nDotv = pbrDesc.hDotv  # PBR.hlsl:58 (sic)

    D = NDF_GGX(normal, halfVec, roughness)
    F = FresnelSchlick(nDotv, f0)
    G = GeometrySmith(pbrDesc)
    fs = f32(0.25) * D * G * F
    fs = fs / (nDotl * nDotv)
    fd = diffuseAlbedo / pi  # rcp(pi)
    ks = F
    kd = (f32(1.0) - F) * (f32(1.0) - metalness)
    brdf = kd * fd + ks * fs
    return brdf


def GetPBRDesc(mat: Material, normal, view, lightDir, pos):
    """PBR.hlsl:73-90."""
    pbrDesc = PBRDesc()
    pbrDesc.normal = normal
    pbrDesc.pos = pos
    pbrDesc.view = view
    halfVec = normalize(view + lightDir)
    pbrDesc.halfVec = halfVec
    pbrDesc.lightDir = lightDir
    pbrDesc.roughness = f32(mat.Roughness)
    pbrDesc.metalness = f32(mat.Metalness)
    pbrDesc.diffuseAlbedo = mat.DiffuseAlbedo[:3]
    pbrDesc.hDotv = max(dot(halfVec, view), f32(0.001))
    pbrDesc.nDotl = max(dot(normal, lightDir), f32(0.001))
    pbrDesc.nDotv = max(dot(normal, view), f32(0.001))
    return pbrDesc


def PBRShading(gLights, mat: Material, normal, v, pos, shadowFactor,
               num_dir, num_point, num_spot):
    """PBR.hlsl:94-148. Only directional lights accumulate: the point and
    spot loops' `result +=` lines are commented out in the reference
    (PBR.hlsl:122,145) — and the point loop would not even compile if
    enabled (`pbr.nDotl` typo, :117)."""
    result = np.zeros(3, f32)
    for i in range(0, num_dir):
        pbrDesc = GetPBRDesc(mat, normal, v, -gLights[i].Direction, pos)
        brdf = GetBRDF(pbrDesc)
        nDotl = pbrDesc.nDotl
        irradiance = gLights[i].Strength * nDotl
        result = result + np.power(shadowFactor[i], f32(5.0)) * brdf \
            * irradiance
    # point / spot: no contribution (commented out in the reference)
    return result


# ---------------------------------------------------------------------------
# Common.hlsl — TBN + PCF
# ---------------------------------------------------------------------------

def NormalSampleToWorldSpace(normalMapSample, unitNormalW, tangentW):
    """Common.hlsl:112-128."""
    normalT = f32(2.0) * normalMapSample - f32(1.0)
    N = unitNormalW
    T = normalize(tangentW - dot(tangentW, N) * N)
    B = np.cross(N, T).astype(f32)
    # mul(normalT, TBN) with TBN rows = (T, B, N)
    return normalT[0] * T + normalT[1] * B + normalT[2] * N


def nrand(uv):
    """Common.hlsl:167-171. `noise` is a float2 broadcast of one scalar,
    so abs(noise.x + noise.y) * 0.5 == frac(...)."""
    noise = frac(np.sin(dot(uv, np.array([12.9898, 78.233], f32)
                            * f32(2.0))) * f32(43758.5453))
    return abs(noise + noise) * f32(0.5)


poissonDisk = np.array(
    [
        [-0.94201624, -0.39906216], [0.94558609, -0.76890725],
        [-0.094184101, -0.92938870], [0.34495938, 0.29387760],
        [-0.91588581, 0.45771432], [-0.81544232, -0.87912464],
        [-0.38277543, 0.27676845], [0.97484398, 0.75648379],
        [0.44323325, -0.97511554], [0.53742981, -0.47373420],
        [-0.26496911, -0.41893023], [0.79197514, 0.19090188],
        [-0.24188840, 0.99706507], [-0.81409955, 0.91437590],
        [0.19984126, 0.78641367], [0.14383161, -0.14100790],
    ],
    dtype=f32,
)  # Common.hlsl:173-183
N_SAMPLE = 16


def SampleCmpLevelZero_gsamShadow(shadow_map, u, v, depth):
    """The gsamShadow static sampler (CRYCHIC.cpp:2649-2658):
    D3D12_FILTER_COMPARISON_MIN_MAG_LINEAR_MIP_POINT, ADDRESS_BORDER with
    OPAQUE_BLACK border, COMPARISON_FUNC_LESS_EQUAL. Per the D3D spec the
    comparison runs per texel and the four 0/1 results are bilinearly
    blended; border texels compare against depth 0."""
    S = shadow_map.shape[0]
    x = u * S - f32(0.5)
    y = v * S - f32(0.5)
    x0 = int(np.floor(x))
    y0 = int(np.floor(y))
    fx = f32(x - x0)
    fy = f32(y - y0)

    def texel(cx, cy):
        if 0 <= cx < S and 0 <= cy < S:
            d = shadow_map[cy, cx]
        else:
            d = f32(0.0)  # opaque-black border
        return f32(1.0) if depth <= d else f32(0.0)

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def oracle_search_radius(width: int) -> f32:
    """Common.hlsl:301: `float search_radius = 5 / width / 2.0f;` with
    `uint width` — `5 / width` is integer division (HLSL int/uint
    arithmetic conversion -> uint), so the radius is 0.0 for any width > 5.
    The author casts width to float for `dx` two lines above (:288) but
    not here. The compiled shader's Poisson disk therefore collapses to a
    single repeated center tap."""
    return f32(5 // width) / f32(2.0)


def CalcCascadeShadowFactorWithPoisson(shadow_maps, index, shadowPosH):
    """Common.hlsl:263-316. shadow_maps: (C, S, S); shadowPosH: float4."""
    shadowPosH = shadowPosH.copy()
    shadowPosH[:3] = shadowPosH[:3] / shadowPosH[3]
    depth = shadowPosH[2]
    width = shadow_maps.shape[1]

    percentLit = f32(0.0)
    rotation_theta = nrand(shadowPosH[:2])
    cos_theta = np.cos(rotation_theta, dtype=f32)
    sin_theta = np.sin(rotation_theta, dtype=f32)
    # float2x2(cos, sin, -sin, cos); mul(p, R) row-vector
    search_radius = oracle_search_radius(width)

    for i in range(N_SAMPLE):
        px, py = poissonDisk[i]
        p = np.array([px * cos_theta - py * sin_theta,
                      px * sin_theta + py * cos_theta], f32)
        offset = p * search_radius
        percentLit = percentLit + SampleCmpLevelZero_gsamShadow(
            shadow_maps[index], shadowPosH[0] + offset[0],
            shadowPosH[1] + offset[1], depth)
    return percentLit / f32(N_SAMPLE)


def CascadeShadowLoop(shadow_maps, gShadowTransforms, gEyePosW, PosW,
                      deferred: bool):
    """The cascade-selection loops: Default.hlsl:124-149 (forward;
    blend band `abs(distance - radius[j]) < 10.0f` below the boundary)
    and DeferredShading.hlsl:53-76 (the `abs(distance - radius[j] < 5.0f)`
    bool-cast quirk: always blend while j < 3)."""
    radius = [f32(30.0), f32(50.0), f32(80.0), f32(100.0)]
    shadowFactor0 = f32(1.0)
    for j in range(4):
        distance = f32(np.sqrt(((gEyePosW - PosW) ** 2).sum()))
        blend = (abs(distance - radius[j]) < f32(10.0)) if not deferred \
            else bool(abs(f32(distance - radius[j] < 5.0)))
        if j < 3 and distance < radius[j] and blend:
            ph = np.concatenate([PosW, [f32(1.0)]]).astype(f32)
            shadowPosH = (ph @ gShadowTransforms[j]).astype(f32)
            shadowPosHNextLevel = (ph @ gShadowTransforms[j + 1]).astype(f32)
            shadowFactor = CalcCascadeShadowFactorWithPoisson(
                shadow_maps, j, shadowPosH)
            shadowFactorNextLevel = CalcCascadeShadowFactorWithPoisson(
                shadow_maps, j + 1, shadowPosHNextLevel)
            shadowFactor0 = f32(0.5) * (shadowFactor + shadowFactorNextLevel)
            break
        elif distance < radius[j]:
            ph = np.concatenate([PosW, [f32(1.0)]]).astype(f32)
            shadowPosH = (ph @ gShadowTransforms[j]).astype(f32)
            shadowFactor0 = CalcCascadeShadowFactorWithPoisson(
                shadow_maps, j, shadowPosH)
            break
    return shadowFactor0


# ---------------------------------------------------------------------------
# Ssao.hlsl
# ---------------------------------------------------------------------------

def SampleLevel_point_clamp(tex, u, v):
    """gsamPointClamp: nearest texel, clamp addressing. tex: (H, W, C).

    D3D12 converts the scaled texel coordinate to 16.8 fixed point with
    round-to-nearest BEFORE flooring (D3D12 spec 7.18.16 "Address
    Snapping"). This matters here: the blur shader's TexC + i*texOffset
    puts full-res point samples exactly on texel boundaries, and raw f32
    floor(u*W) is one ulp below the boundary (4.9999997 -> texel 4) while
    hardware's fixed-point snap reads texel 5."""
    H, W = tex.shape[:2]
    x = int(np.floor(np.round(f32(u * W) * 256.0) / 256.0))
    y = int(np.floor(np.round(f32(v * H) * 256.0) / 256.0))
    x = min(max(x, 0), W - 1)
    y = min(max(y, 0), H - 1)
    return tex[y, x]


def SampleLevel_linear_border_white(tex, u, v):
    """gsamDepthMap (CRYCHIC.cpp BuildSsaoRootSignature, s2):
    MIN_MAG_MIP_LINEAR, ADDRESS_BORDER, OPAQUE_WHITE border. tex: (H, W)
    single channel (the depth buffer)."""
    H, W = tex.shape[:2]
    x = u * W - f32(0.5)
    y = v * H - f32(0.5)
    x0 = int(np.floor(x))
    y0 = int(np.floor(y))
    fx = f32(x - x0)
    fy = f32(y - y0)

    def texel(cx, cy):
        if 0 <= cx < W and 0 <= cy < H:
            return tex[cy, cx]
        return f32(1.0)  # opaque-white border

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def SampleLevel_linear_wrap(tex, u, v):
    """gsamLinearWrap: bilinear, wrap addressing. tex: (H, W, C)."""
    H, W = tex.shape[:2]
    x = u * W - f32(0.5)
    y = v * H - f32(0.5)
    x0 = int(np.floor(x))
    y0 = int(np.floor(y))
    fx = f32(x - x0)
    fy = f32(y - y0)

    def texel(cx, cy):
        return tex[cy % H, cx % W]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def OcclusionFunction(distZ, gSurfaceEpsilon, gOcclusionFadeStart,
                      gOcclusionFadeEnd):
    """Ssao.hlsl:76-108."""
    occlusion = f32(0.0)
    if distZ > gSurfaceEpsilon:
        fadeLength = gOcclusionFadeEnd - gOcclusionFadeStart
        occlusion = saturate((gOcclusionFadeEnd - distZ) / fadeLength)
    return occlusion


def NdcDepthToViewDepth(z_ndc, gProj):
    """Ssao.hlsl:110-115."""
    viewZ = gProj[3][2] / (z_ndc - gProj[2][2])
    return viewZ


def SsaoPS(TexC, gNormalMap, gDepthMap, gRandomVecMap, gProj, gInvProj,
           gOffsetVectors, gOcclusionRadius=f32(0.5),
           gOcclusionFadeStart=f32(0.2), gOcclusionFadeEnd=f32(1.0),
           gSurfaceEpsilon=f32(0.05), gSampleCount=14):
    """Ssao.hlsl PS (:117-198) for one pixel at screen uv TexC.

    gNormalMap: (H, W, 3) full-res view normals; gDepthMap: (H, W) NDC
    depth; gRandomVecMap: (256, 256, 3) in [0, 1] (RGBA8-quantized);
    matrices row-vector f32. The VS part (PosV from the quad corner
    through gInvProj) is folded in: PosV = near-plane view ray at TexC.
    """
    # VS: PosH = (2u-1, 1-2v, 0, 1); PosV = (PosH @ InvProj).xyz / .w
    PosH = np.array([f32(2.0) * TexC[0] - f32(1.0),
                     f32(1.0) - f32(2.0) * TexC[1], f32(0.0), f32(1.0)], f32)
    ph = (PosH @ gInvProj).astype(f32)
    PosV = ph[:3] / ph[3]

    n = normalize(SampleLevel_point_clamp(gNormalMap, TexC[0], TexC[1])[:3])
    pz = SampleLevel_linear_border_white(gDepthMap, TexC[0], TexC[1])
    pz = NdcDepthToViewDepth(pz, gProj)

    p = (pz / PosV[2]) * PosV

    randVec = f32(2.0) * SampleLevel_linear_wrap(
        gRandomVecMap, f32(4.0) * TexC[0], f32(4.0) * TexC[1])[:3] - f32(1.0)

    occlusionSum = f32(0.0)
    for i in range(gSampleCount):
        offset = reflect(gOffsetVectors[i][:3].astype(f32), randVec)
        flip = sign(dot(offset, n))
        q = p + flip * gOcclusionRadius * offset

        # mul(float4(q,1), gProjTex); ProjTex = Proj @ T (NDC->tex)
        projQ = (np.concatenate([q, [f32(1.0)]]).astype(f32)
                 @ gProj).astype(f32)
        # T: u = x*0.5+0.5, v = -y*0.5+0.5 (the reference's gProjTex bakes
        # this NDC->texture matrix, CRYCHIC.cpp:908-914)
        projQ = projQ / projQ[3]
        qu = projQ[0] * f32(0.5) + f32(0.5)
        qv = -projQ[1] * f32(0.5) + f32(0.5)

        rz = SampleLevel_linear_border_white(gDepthMap, qu, qv)
        rz = NdcDepthToViewDepth(rz, gProj)
        r = (rz / q[2]) * q

        distZ = p[2] - r[2]
        dp = max(dot(n, normalize(r - p)), f32(0.0))
        occlusion = dp * OcclusionFunction(distZ, gSurfaceEpsilon,
                                           gOcclusionFadeStart,
                                           gOcclusionFadeEnd)
        occlusionSum = occlusionSum + occlusion

    occlusionSum = occlusionSum / f32(gSampleCount)
    access = f32(1.0) - occlusionSum
    return saturate(np.power(access, f32(6.0)))


def SsaoBlurPS(TexC, gInputMap, gNormalMap, gDepthMap, gProj, blurWeights,
               gInvRenderTargetSize, horizontal: bool, gBlurRadius=5):
    """SsaoBlur.hlsl PS (:85-146) for one pixel.

    gInputMap: (h, w) half-res ambient; gNormalMap: (H, W, 3) full-res;
    gDepthMap: (H, W) full-res NDC depth; gInvRenderTargetSize: the SSAO
    (half-res) target's inverse size (Ssao.cpp sets the CB from its own
    map dimensions)."""
    if horizontal:
        texOffset = np.array([gInvRenderTargetSize[0], f32(0.0)], f32)
    else:
        texOffset = np.array([f32(0.0), gInvRenderTargetSize[1]], f32)

    inp = gInputMap[..., None] if gInputMap.ndim == 2 else gInputMap
    color = blurWeights[gBlurRadius] * SampleLevel_point_clamp(
        inp, TexC[0], TexC[1])
    totalWeight = blurWeights[gBlurRadius]

    centerNormal = SampleLevel_point_clamp(gNormalMap, TexC[0], TexC[1])[:3]
    centerDepth = NdcDepthToViewDepth(
        SampleLevel_linear_border_white(gDepthMap, TexC[0], TexC[1]), gProj)

    for i in range(-gBlurRadius, gBlurRadius + 1):
        if i == 0:
            continue
        tex = TexC + f32(i) * texOffset
        neighborNormal = SampleLevel_point_clamp(gNormalMap, tex[0],
                                                 tex[1])[:3]
        neighborDepth = NdcDepthToViewDepth(
            SampleLevel_linear_border_white(gDepthMap, tex[0], tex[1]),
            gProj)
        if (dot(neighborNormal, centerNormal) >= f32(0.8)
                and abs(neighborDepth - centerDepth) <= f32(0.2)):
            weight = blurWeights[i + gBlurRadius]
            color = color + weight * SampleLevel_point_clamp(
                inp, tex[0], tex[1])
            totalWeight = totalWeight + weight
    return color / totalWeight


# ---------------------------------------------------------------------------
# Default.hlsl / DeferredShading.hlsl lighting tails
# ---------------------------------------------------------------------------

def DefaultPSTail(diffuseAlbedo, normalMapSample, bumpedNormalW, PosW,
                  gEyePosW, ambientAccess, gAmbientLight, fresnelR0,
                  roughness, metalness, gLights, num_dir, shadowFactor0,
                  reflectionColor):
    """Default.hlsl:115-185 from the ambient term down (the texture and
    shadow fetches enter as arguments). Returns float4 litColor."""
    toEyeW = normalize(gEyePosW - PosW)
    ambient = ambientAccess * gAmbientLight * diffuseAlbedo

    shadowFactors = [f32(1.0)] * MaxLights
    shadowFactors[0] = shadowFactor0

    shininess = (f32(1.0) - roughness) * normalMapSample[3]
    mat = Material(diffuseAlbedo, fresnelR0, roughness, metalness, shininess)
    directLight = PBRShading(gLights, mat, bumpedNormalW, toEyeW, PosW,
                             shadowFactors, num_dir, 0, 0)
    directLight = np.concatenate([directLight, [f32(0.0)]]).astype(f32)

    directLight = directLight / (directLight + f32(1.0))
    directLight = np.power(directLight, f32(1.0) / f32(2.2))

    litColor = ambient + directLight

    r = reflect(-toEyeW, bumpedNormalW)
    fresnelFactor = SchlickFresnel(fresnelR0, bumpedNormalW, r)
    litColor = litColor.copy()
    litColor[:3] = litColor[:3] + shininess * fresnelFactor \
        * reflectionColor[:3]
    litColor[3] = diffuseAlbedo[3]
    return litColor


# ---------------------------------------------------------------------------
# CRYCHIC.cpp cascade fitting (UpdateCascadeShadowTransform :634-815)
# ---------------------------------------------------------------------------
# Scalar transliteration of the host-side cascade fit, including the
# DirectXMath matrix builders it calls (XMMatrixPerspectiveFovLH,
# XMMatrixLookAtLH, XMMatrixOrthographicOffCenterLH) so this shares no
# matrix code with crychic_renderer_tpu.utils.mathutil. Row-vector
# convention throughout (XMVector3Transform(v, M) = [v, 1] @ M).

def XMMatrixPerspectiveFovLH(FovAngleY, AspectRatio, NearZ, FarZ):
    SinFov = f32(np.sin(f32(0.5) * f32(FovAngleY)))
    CosFov = f32(np.cos(f32(0.5) * f32(FovAngleY)))
    Height = CosFov / SinFov
    Width = Height / f32(AspectRatio)
    fRange = f32(FarZ) / (f32(FarZ) - f32(NearZ))
    M = np.zeros((4, 4), f32)
    M[0, 0] = Width
    M[1, 1] = Height
    M[2, 2] = fRange
    M[2, 3] = f32(1.0)
    M[3, 2] = -fRange * f32(NearZ)
    return M


def XMMatrixLookAtLH(EyePosition, FocusPosition, UpDirection):
    # XMMatrixLookToLH(eye, focus - eye, up)
    eye = np.asarray(EyePosition, f32)[:3]
    EyeDirection = np.asarray(FocusPosition, f32)[:3] - eye
    up = np.asarray(UpDirection, f32)[:3]
    R2 = normalize(EyeDirection)
    R0 = normalize(np.cross(up, R2).astype(f32))
    R1 = np.cross(R2, R0).astype(f32)
    NegEyePosition = -eye
    D0 = dot(R0, NegEyePosition)
    D1 = dot(R1, NegEyePosition)
    D2 = dot(R2, NegEyePosition)
    M = np.zeros((4, 4), f32)
    M[:3, 0] = R0
    M[:3, 1] = R1
    M[:3, 2] = R2
    M[3, 0] = D0
    M[3, 1] = D1
    M[3, 2] = D2
    M[3, 3] = f32(1.0)
    return M


def XMMatrixOrthographicOffCenterLH(l, r, b, t, NearZ, FarZ):
    ReciprocalWidth = f32(1.0) / (f32(r) - f32(l))
    ReciprocalHeight = f32(1.0) / (f32(t) - f32(b))
    fRange = f32(1.0) / (f32(FarZ) - f32(NearZ))
    M = np.zeros((4, 4), f32)
    M[0, 0] = ReciprocalWidth + ReciprocalWidth
    M[1, 1] = ReciprocalHeight + ReciprocalHeight
    M[2, 2] = fRange
    M[3, 0] = -(f32(l) + f32(r)) * ReciprocalWidth
    M[3, 1] = -(f32(t) + f32(b)) * ReciprocalHeight
    M[3, 2] = -fRange * f32(NearZ)
    M[3, 3] = f32(1.0)
    return M


def UpdateCascadeShadowTransform(mCameraView, fovY, aspect, cameraNearZ,
                                 cameraFarZ, lightDir, shadowMapWidth,
                                 snap_fracs_out=None):
    """CRYCHIC.cpp:634-815, one pass over the 4 cascades.

    mCameraView: (4, 4) row-vector view matrix (Camera::GetView()).
    Returns (lightViews, lightProjs, shadowTransforms), each (4, 4, 4).

    snap_fracs_out: optional list; receives each cascade's PRE-floor
    center/texel triple so callers can detect floor knife edges (where
    f32 rounding differences between two implementations legitimately
    flip the snap by one texel).
    """
    zNear = [f32(cameraNearZ), f32(30.0), f32(50.0), f32(80.0)]
    zFar = [f32(30.0), f32(50.0), f32(80.0), f32(cameraFarZ)]
    lightDir = np.asarray(lightDir, f32)

    lightViews, lightProjs, shadowTransforms = [], [], []
    for i in range(4):
        mCameraProj = XMMatrixPerspectiveFovLH(fovY, aspect, zNear[i],
                                               zFar[i])
        mInvViewProj = np.linalg.inv(
            (mCameraView @ mCameraProj).astype(f32)).astype(f32)
        # corners in NDC space (:656-668)
        corners = np.array([
            [-1.0, +1.0, 0.0, +1.0],
            [+1.0, +1.0, 0.0, +1.0],
            [+1.0, -1.0, 0.0, +1.0],
            [-1.0, -1.0, 0.0, +1.0],
            [-1.0, +1.0, 1.0, +1.0],
            [+1.0, +1.0, 1.0, +1.0],
            [+1.0, -1.0, 1.0, +1.0],
            [-1.0, -1.0, 1.0, +1.0],
        ], f32)
        # transform from ndc to world (:688-705): XMVector3Transform uses
        # (x, y, z, 1); the loop divides xyz by the transformed w
        for j in range(8):
            c = np.array([corners[j, 0], corners[j, 1], corners[j, 2],
                          f32(1.0)], f32)
            cw = c @ mInvViewProj
            corners[j] = cw
            corners[j, 0] = corners[j, 0] / cw[3]
            corners[j, 1] = corners[j, 1] / cw[3]
            corners[j, 2] = corners[j, 2] / cw[3]

        # compute maxDistance (:707-714)
        crossFar = f32(np.sqrt(
            (corners[7, 0] - corners[5, 0]) ** 2
            + (corners[7, 1] - corners[5, 1]) ** 2
            + (corners[7, 2] - corners[5, 2]) ** 2))
        crossNear2Far = f32(np.sqrt(
            (corners[3, 0] - corners[5, 0]) ** 2
            + (corners[3, 1] - corners[5, 1]) ** 2
            + (corners[3, 2] - corners[5, 2]) ** 2))
        boundingBoxLength = crossFar if crossFar > crossNear2Far \
            else crossNear2Far

        targetPos = f32(0.5) * (corners[3, :3] + corners[5, :3])
        distance = boundingBoxLength
        lightPos = -distance * lightDir + targetPos
        up = np.array([0.0, 1.0, 0.0], f32)
        lightView = XMMatrixLookAtLH(lightPos, targetPos, up)

        # transform world to light view space (:740-745)
        cornersLight = np.zeros((8, 3), f32)
        for j in range(8):
            c = np.array([corners[j, 0], corners[j, 1], corners[j, 2],
                          f32(1.0)], f32)
            cornersLight[j] = (c @ lightView)[:3]

        vMin = cornersLight.min(axis=0)
        vMax = cornersLight.max(axis=0)

        # texel snap (:758-781): floor-snap ALL THREE center components
        fWorldUnitsPerTexel = boundingBoxLength / f32(shadowMapWidth)
        fCenter = (f32(0.5) * (vMin + vMax)).astype(f32)
        if snap_fracs_out is not None:
            snap_fracs_out.append(
                (fCenter / fWorldUnitsPerTexel).astype(f32).copy())
        for k in range(3):
            fCenter[k] = fCenter[k] / fWorldUnitsPerTexel
            fCenter[k] = f32(np.floor(fCenter[k]))
            fCenter[k] = fCenter[k] * fWorldUnitsPerTexel

        l = fCenter[0] - f32(0.5) * boundingBoxLength
        b = fCenter[1] - f32(0.5) * boundingBoxLength
        n = fCenter[2] - f32(0.5) * boundingBoxLength
        r = fCenter[0] + f32(0.5) * boundingBoxLength
        t = fCenter[1] + f32(0.5) * boundingBoxLength
        f = fCenter[2] + f32(0.5) * boundingBoxLength

        lightProj = XMMatrixOrthographicOffCenterLH(l, r, b, t, n, f)
        T = np.array([
            [0.5, 0.0, 0.0, 0.0],
            [0.0, -0.5, 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
            [0.5, 0.5, 0.0, 1.0],
        ], f32)
        shadowTransform = (lightView @ lightProj @ T).astype(f32)
        lightViews.append(lightView)
        lightProjs.append(lightProj)
        shadowTransforms.append(shadowTransform)
    return (np.stack(lightViews), np.stack(lightProjs),
            np.stack(shadowTransforms))


# ---------------------------------------------------------------------------
# GBuffer.hlsl encode/decode (:22-43)
# ---------------------------------------------------------------------------

def EncodePBRToGBuffer(pos, metalness, albedo, roughness, normal):
    GBuffer0 = np.concatenate([pos, [metalness]]).astype(f32)
    GBuffer1 = np.concatenate([albedo, [roughness]]).astype(f32)
    GBuffer2 = np.concatenate([normal, [f32(1.0)]]).astype(f32)
    GBuffer3 = np.zeros(4, f32)
    return GBuffer0, GBuffer1, GBuffer2, GBuffer3


def DecodeGBuffer(gBuffer0, gBuffer1, gBuffer2, gBuffer3):
    return dict(
        pos=gBuffer0[:3],
        metalness=gBuffer0[3],
        albedo=gBuffer1[:3],
        roughness=gBuffer1[3],
        normal=normalize(gBuffer2[:3]),
    )
