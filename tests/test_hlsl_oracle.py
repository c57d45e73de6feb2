"""Production shading math vs the independent HLSL oracle.

tests/hlsl_oracle.py is a scalar, line-by-line transliteration of the
reference shaders sharing nothing with crychic_renderer_tpu.ops. These
tests evaluate both at ~1k random configurations: a transcription error in
ops/ (swapped coefficient, wrong constant, missing clamp) fails here even
though the repo's golden images are renders of this same codebase.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from tests import hlsl_oracle as ho


RNG = np.random.RandomState(20260820)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _mk_lights(num_dir=0, num_point=0, num_spot=0, rng=RNG):
    """Random reference-shaped lights as (oracle list, production Lights)."""
    from crychic_renderer_tpu.models.materials import Lights

    lights = Lights.empty(ambient=(0.2, 0.2, 0.25, 1.0))
    oracle = []
    n = num_dir + num_point + num_spot
    for i in range(n):
        d = _unit(rng, 1)[0]
        s = rng.uniform(0.2, 1.2, 3).astype(np.float32)
        p = rng.uniform(-4, 4, 3).astype(np.float32)
        fs = np.float32(rng.uniform(0.5, 2.0))
        fe = np.float32(rng.uniform(4.0, 12.0))
        sp = np.float32(rng.uniform(1.0, 16.0))
        lights.direction[i] = tuple(d)
        lights.strength[i] = tuple(s)
        lights.position[i] = tuple(p)
        lights.falloff_start[i] = float(fs)
        lights.falloff_end[i] = float(fe)
        lights.spot_power[i] = float(sp)
        oracle.append(ho.Light(Strength=s, FalloffStart=fs, Direction=d,
                               FalloffEnd=fe, Position=p, SpotPower=sp))
    lights.num_dir = num_dir
    lights.num_point = num_point
    lights.num_spot = num_spot
    return oracle, lights


def test_pbr_shading_matches_oracle():
    """pbr_shading == PBRShading (PBR.hlsl:91-149) incl. the nDotv:=hDotv
    quirk, the k=(r+1)^2/8 geometry term, and pow(shadow,5) on light 0."""
    from crychic_renderer_tpu.ops import shading

    N = 400
    rng = np.random.RandomState(7)
    normal = _unit(rng, N)
    view = _unit(rng, N)
    pos = rng.uniform(-10, 10, (N, 3)).astype(np.float32)
    albedo = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    rough = rng.uniform(0.05, 1.0, (N, 1)).astype(np.float32)
    metal = rng.uniform(0.0, 1.0, (N, 1)).astype(np.float32)
    sf = rng.uniform(0, 1, (N, 1)).astype(np.float32)

    for num_dir in (1, 3):
        oracle_lights, lights = _mk_lights(num_dir=num_dir, rng=rng)
        got = np.asarray(shading.pbr_shading(
            lights, jnp.asarray(normal), jnp.asarray(view),
            jnp.asarray(pos), jnp.asarray(albedo), jnp.asarray(rough),
            jnp.asarray(metal), jnp.asarray(sf)))
        for i in range(0, N, 13):
            shadow = [sf[i, 0]] + [np.float32(1.0)] * (ho.MaxLights - 1)
            mat = ho.Material(albedo[i], np.zeros(3, np.float32),
                              rough[i, 0], metal[i, 0], np.float32(0))
            want = ho.PBRShading(oracle_lights, mat, normal[i], view[i],
                                 pos[i], shadow, num_dir, 0, 0)
            np.testing.assert_allclose(got[i], want, rtol=2e-4, atol=2e-5)


def test_blinn_phong_compute_lighting_matches_oracle():
    """compute_lighting == ComputeLighting (LightingUtil.hlsl:156-186):
    dir + point + spot evaluators, linear attenuation, range cut, LDR
    spec scale."""
    from crychic_renderer_tpu.ops import shading

    N = 300
    rng = np.random.RandomState(11)
    normal = _unit(rng, N)
    to_eye = _unit(rng, N)
    pos = rng.uniform(-6, 6, (N, 3)).astype(np.float32)
    albedo = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    r0 = rng.uniform(0.02, 0.9, (N, 3)).astype(np.float32)
    shin = rng.uniform(0.05, 1.0, (N, 1)).astype(np.float32)
    sf = rng.uniform(0, 1, (N, 1)).astype(np.float32)

    oracle_lights, lights = _mk_lights(num_dir=1, num_point=2, num_spot=1,
                                       rng=rng)
    got = np.asarray(shading.compute_lighting(
        lights, jnp.asarray(normal), jnp.asarray(to_eye), jnp.asarray(pos),
        jnp.asarray(albedo), jnp.asarray(r0), jnp.asarray(shin),
        jnp.asarray(sf)))
    for i in range(0, N, 7):
        shadow = [sf[i, 0]] + [np.float32(1.0)] * (ho.MaxLights - 1)
        mat = ho.Material(albedo[i], r0[i], np.float32(0), np.float32(0),
                          shin[i, 0])
        want = ho.ComputeLighting(oracle_lights, mat, pos[i], normal[i],
                                  to_eye[i], shadow, 1, 2, 1)
        np.testing.assert_allclose(got[i], want, rtol=3e-4, atol=3e-5)


def test_normal_map_tbn_matches_oracle():
    from crychic_renderer_tpu.ops import shading

    rng = np.random.RandomState(3)
    N = 200
    nm = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    un = _unit(rng, N)
    tan = rng.normal(size=(N, 3)).astype(np.float32)
    got = np.asarray(shading.normal_sample_to_world(
        jnp.asarray(nm), jnp.asarray(un), jnp.asarray(tan)))
    for i in range(0, N, 9):
        want = ho.NormalSampleToWorldSpace(nm[i], un[i], tan[i])
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)


def test_tonemap_and_sky_reflection_tail_matches_oracle():
    """The lighting tail composed exactly as passes/frame.lighting_pass
    composes it (ambient + tonemapped direct, then sky reflection added
    un-tonemapped, alpha from albedo) == Default.hlsl:115-185."""
    from crychic_renderer_tpu.ops import shading

    rng = np.random.RandomState(5)
    N = 200
    albedo = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    nms = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    rough = rng.uniform(0.05, 1.0, (N, 1)).astype(np.float32)
    metal = np.full((N, 1), 0.5, np.float32)  # the reference's constant
    pos = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    eye = np.array([1.0, 3.0, -9.0], np.float32)
    access = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    amb_light = np.array([0.25, 0.25, 0.35, 1.0], np.float32)
    cube = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    sf0 = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    unb = _unit(rng, N)
    tan = rng.normal(size=(N, 3)).astype(np.float32)

    oracle_lights, lights = _mk_lights(num_dir=3, rng=rng)

    # production composition (the exact sequence of lighting_pass)
    bumped = shading.normal_sample_to_world(jnp.asarray(nms[:, :3]),
                                            jnp.asarray(unb),
                                            jnp.asarray(tan))
    normal = shading.normalize(bumped)
    view = shading.normalize(jnp.asarray(eye) - pos)
    fres_r0 = 0.04 * (1.0 - metal) + albedo[:, :3] * metal
    ambient = access * amb_light[None, :] * albedo
    direct = shading.pbr_shading(lights, normal, view, jnp.asarray(pos),
                                 jnp.asarray(albedo), jnp.asarray(rough),
                                 jnp.asarray(metal), jnp.asarray(sf0))
    direct = shading.tonemap_direct(direct)
    lit = ambient[:, :3] + direct
    shininess = (1.0 - rough) * nms[:, 3:4]
    r = shading.reflect(-view, normal)
    fres = shading.schlick_fresnel(jnp.asarray(fres_r0), normal, r)
    lit = lit + shininess * fres * cube[:, :3]
    got = np.asarray(lit)

    for i in range(0, N, 11):
        bw = ho.NormalSampleToWorldSpace(nms[i, :3], unb[i], tan[i])
        # Default.hlsl normalizes via lighting's use of bumpedNormalW as-is;
        # production normalizes g["normal_w"] in lighting_pass — the HLSL
        # bumped normal is near-unit (TBN of a unit sample); match by
        # normalizing the oracle's too (frame parity keeps this explicit)
        bw = ho.normalize(bw)
        shadow = [sf0[i, 0]] + [np.float32(1.0)] * (ho.MaxLights - 1)
        want = ho.DefaultPSTail(
            albedo[i], nms[i], bw, pos[i], eye, access[i, 0], amb_light,
            fres_r0[i], rough[i, 0], metal[i, 0], oracle_lights, 3,
            shadow[0], cube[i])
        np.testing.assert_allclose(got[i], want[:3], rtol=3e-4, atol=3e-5)


# ---------------------------------------------------------------------------
# PCF
# ---------------------------------------------------------------------------

def _mk_shadow_maps(rng, C=4, S=64):
    """Random maps with texels on EVEN u16 grid values and (see
    _mk_shadow_pos) receivers at odd-plus-half grid values: the windowed
    path's u16 quantization is exact and its half-step comparison offset
    (depth*65535 - 0.5 <= q) agrees with the oracle's float compare for
    every draw."""
    q = rng.randint(0, 32768, (C, S, S)).astype(np.float32) * 2.0 / 65535.0
    return q.astype(np.float32)


def _mk_shadow_pos(rng, N):
    uv = rng.uniform(0.08, 0.92, (N, 2)).astype(np.float32)
    k = rng.randint(0, 32767, N).astype(np.float32) * 2.0 + 1.0
    depth = ((k + 0.5) / 65535.0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N).astype(np.float32)
    pos = np.stack([uv[:, 0] * w, uv[:, 1] * w, depth * w, w], -1)
    return pos.astype(np.float32)


def test_poisson_pcf_matches_oracle():
    """poisson_pcf == CalcCascadeShadowFactorWithPoisson
    (Common.hlsl:263-316) — including the compiled search radius
    `5 / width / 2.0f` = 0.0 (int/uint division; hlsl_oracle module doc)."""
    from crychic_renderer_tpu.ops import shadows

    rng = np.random.RandomState(17)
    S = 64
    maps = _mk_shadow_maps(rng, 4, S)
    N = 256
    pos = _mk_shadow_pos(rng, N)
    casc = rng.randint(0, 4, N).astype(np.int32)

    got = np.asarray(shadows.poisson_pcf(
        jnp.asarray(maps), jnp.asarray(casc), jnp.asarray(pos), S))
    for i in range(N):
        want = ho.CalcCascadeShadowFactorWithPoisson(maps, casc[i],
                                                     pos[i].copy())
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)


def test_poisson_pcf_windowed_matches_oracle():
    """The windowed (superwindow u16) production form equals the oracle
    bit-for-bit on u16-grid maps."""
    from crychic_renderer_tpu.ops import shadows

    rng = np.random.RandomState(23)
    S = 64
    maps = _mk_shadow_maps(rng, 4, S)
    N = 256
    pos = _mk_shadow_pos(rng, N)
    casc = rng.randint(0, 4, N).astype(np.int32)

    got = np.asarray(shadows.poisson_pcf_windowed(
        jnp.asarray(maps), jnp.asarray(casc), jnp.asarray(pos), S))
    for i in range(N):
        want = ho.CalcCascadeShadowFactorWithPoisson(maps, casc[i],
                                                     pos[i].copy())
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)


def test_cascade_shadow_factor_matches_oracle_loop():
    """cascade_shadow_factor == the Default.hlsl:124-149 (forward) and
    DeferredShading.hlsl:53-76 (always-blend quirk) cascade loops."""
    from crychic_renderer_tpu.ops import shadows

    rng = np.random.RandomState(29)
    S = 64
    maps = _mk_shadow_maps(rng, 4, S)
    eye = np.array([0.0, 4.0, -10.0], np.float32)

    # row-vector transforms (p @ M) mapping world x/z into in-map uv with
    # wide margins and world y into depth around 0.5
    xf = np.zeros((4, 4, 4), np.float32)
    for c in range(4):
        s = 1.0 / 330.0
        M = np.zeros((4, 4), np.float32)
        M[0, 0] = s            # u = x*s + 0.5
        M[3, 0] = 0.5
        M[2, 1] = s            # v = z*s + 0.5
        M[3, 1] = 0.5
        M[1, 2] = 0.003        # depth = y*0.003 + 0.4 + 0.05c
        M[3, 2] = 0.4 + 0.05 * c
        M[3, 3] = 1.0
        xf[c] = M
    N = 240
    # positions spread across all cascade distances incl. past 100
    t = rng.uniform(0, 1, N).astype(np.float32)
    dirs = _unit(rng, N)
    pos = eye[None, :] + dirs * (t[:, None] * 110.0)
    pos = pos.astype(np.float32)

    for quirk in (False, True):
        got = np.asarray(shadows.cascade_shadow_factor(
            jnp.asarray(maps), jnp.asarray(xf), jnp.asarray(pos),
            jnp.asarray(eye), S, deferred_blend_quirk=quirk))
        for i in range(0, N, 5):
            want = ho.CascadeShadowLoop(maps, xf, eye, pos[i],
                                        deferred=quirk)
            np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"pixel {i} quirk={quirk}")


# ---------------------------------------------------------------------------
# SSAO
# ---------------------------------------------------------------------------

def _ssao_setup(rng, H=32, W=48):
    from crychic_renderer_tpu.models.camera import Camera
    from crychic_renderer_tpu.ops import ssao as ssao_ops

    cam = Camera()
    cam.set_lens(0.25 * np.pi, W / H, 1.0, 100.0)
    proj = cam.proj.astype(np.float32)
    inv_proj = np.linalg.inv(proj).astype(np.float32)

    # smooth-ish random scene: depth in (0.2, 0.9), normals near +z view
    depth = (0.5 + 0.3 * np.sin(np.linspace(0, 7, W)[None, :]
                                + np.linspace(0, 5, H)[:, None])
             + 0.05 * rng.uniform(-1, 1, (H, W))).astype(np.float32)
    depth = np.clip(depth, 0.15, 0.95)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm[..., 2] += 2.5
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

    offsets = ssao_ops.build_offset_vectors()
    rtex = ssao_ops.build_random_vector_texture()
    return proj, inv_proj, depth, nrm, offsets, rtex


def test_ssao_occlusion_matches_oracle():
    """ssao_occlusion == Ssao.hlsl PS at every half-res pixel: linear
    border-white depth taps on the FULL-RES depth map, linear-wrap
    random vectors, hemisphere reflection/flip, linear fade, pow-6."""
    from crychic_renderer_tpu.ops import ssao as ssao_ops
    from crychic_renderer_tpu.passes import frame as fr
    from crychic_renderer_tpu.config import RenderConfig

    rng = np.random.RandomState(31)
    H, W = 32, 48
    proj, inv_proj, depth, nrm, offsets, rtex = _ssao_setup(rng, H, W)

    cfg = RenderConfig(width=W, height=H, ssao_scale=2)
    n_half, d_half = fr.ssao_inputs_half(cfg, jnp.asarray(nrm),
                                         jnp.asarray(depth))
    rfield = ssao_ops.build_random_field(rtex, H // 2, W // 2)
    got = np.asarray(ssao_ops.ssao_occlusion(
        n_half, d_half, jnp.asarray(proj), jnp.asarray(inv_proj),
        jnp.asarray(offsets), random_field=jnp.asarray(rfield),
        tap_depth=jnp.asarray(depth)))

    hh, hw = H // 2, W // 2
    rtex_q = np.round(np.clip(rtex, 0, 1) * 255.0) / 255.0
    for j in range(0, hh, 3):
        for i in range(0, hw, 5):
            TexC = np.array([(i + 0.5) / hw, (j + 0.5) / hh], np.float32)
            want = ho.SsaoPS(TexC, nrm, depth, rtex_q.astype(np.float32),
                             proj, inv_proj, offsets)
            np.testing.assert_allclose(
                got[j, i], want, rtol=5e-4, atol=5e-4,
                err_msg=f"ssao pixel ({j},{i})")


def test_ssao_blur_matches_oracle():
    """bilateral_blur == SsaoBlur.hlsl PS including the border-white
    depth reads past the screen edge."""
    from crychic_renderer_tpu.ops import ssao as ssao_ops
    from crychic_renderer_tpu.passes import frame as fr
    from crychic_renderer_tpu.config import RenderConfig

    rng = np.random.RandomState(37)
    H, W = 32, 48
    proj, inv_proj, depth, nrm, offsets, rtex = _ssao_setup(rng, H, W)
    cfg = RenderConfig(width=W, height=H, ssao_scale=2)
    n_half, d_half = fr.ssao_inputs_half(cfg, jnp.asarray(nrm),
                                         jnp.asarray(depth))
    amb = rng.uniform(0, 1, (H // 2, W // 2)).astype(np.float32)
    weights = ssao_ops.calc_gauss_weights(2.5)

    d_view = ssao_ops.ndc_depth_to_view(d_half, proj[2, 2], proj[3, 2])
    for horizontal in (True, False):
        got = np.asarray(ssao_ops.bilateral_blur(
            jnp.asarray(amb), n_half, d_view, weights, horizontal,
            border_depth_view=float(ssao_ops.ndc_depth_to_view(
                1.0, proj[2, 2], proj[3, 2]))))
        hh, hw = H // 2, W // 2
        inv_sz = np.array([1.0 / hw, 1.0 / hh], np.float32)
        n_half_np = np.asarray(n_half)
        for j in range(0, hh, 5):
            for i in range(0, hw, 7):
                TexC = np.array([(i + 0.5) / hw, (j + 0.5) / hh],
                                np.float32)
                # the oracle samples the FULL-res normal/depth maps the way
                # the blur shader does
                want = ho.SsaoBlurPS(TexC, amb, nrm, depth, proj, weights,
                                     inv_sz, horizontal)
                np.testing.assert_allclose(
                    got[j, i], np.asarray(want).reshape(-1)[0],
                    rtol=5e-4, atol=5e-4,
                    err_msg=f"blur {horizontal} pixel ({j},{i})")


# ---------------------------------------------------------------------------
# Cascade fitting (CRYCHIC.cpp:634-815) and G-buffer codec (GBuffer.hlsl)
# ---------------------------------------------------------------------------

def test_cascade_fit_matches_oracle():
    """models.cascades.fit_cascades == the CRYCHIC.cpp:634-815
    transliteration, at sub-texel precision: the shadow transforms are
    compared by projecting world points into shadow uv, with a bound of
    a QUARTER texel — a one-texel snapping error in the ortho-center fit
    moves every uv by exactly one texel and fails loudly."""
    from crychic_renderer_tpu.models.camera import Camera
    from crychic_renderer_tpu.models import cascades

    rng = np.random.RandomState(31)
    S = 2048
    compared = 0
    for trial in range(12):
        cam = Camera()
        aspect = float(rng.uniform(1.0, 2.0))
        fov = float(rng.uniform(0.2, 0.45) * np.pi)
        cam.set_lens(fov, aspect, 1.0, 100.0)
        pos = rng.uniform(-20, 20, 3).astype(np.float32)
        pos[1] = rng.uniform(1.0, 15.0)
        target = pos + _unit(rng, 1)[0] * 10.0
        cam.look_at(pos, target, (0.0, 1.0, 0.0))
        # downward-ish light (the reference's casters all point down;
        # avoids the lookAt degeneracy at light || up)
        ld = _unit(rng, 1)[0]
        ld[1] = -abs(ld[1]) - 0.3
        light_dir = (ld / np.linalg.norm(ld)).astype(np.float32)

        got = cascades.fit_cascades(cam, light_dir, S)
        snap_fracs = []
        want_v, want_p, want_t = ho.UpdateCascadeShadowTransform(
            cam.view, cam.fov_y, cam.aspect, cam.near_z, cam.far_z,
            light_dir, S, snap_fracs_out=snap_fracs)

        # sample world points inside each cascade slice
        for c in range(4):
            # floor-snap knife edge: when center/texel sits within f32
            # rounding of an integer, the two (both-correct) f32
            # pipelines legitimately floor to different texels — skip
            # (observed distances: knife edges < 5e-5, regular >= 4e-3)
            frac = snap_fracs[c] - np.floor(snap_fracs[c])
            if np.minimum(frac, 1.0 - frac).min() < 2e-3:
                continue
            compared += 1
            zs = [(1.0, 30.0), (30.0, 50.0), (50.0, 80.0),
                  (80.0, 100.0)][c]
            depth = rng.uniform(zs[0], zs[1], 16).astype(np.float32)
            x = rng.uniform(-0.8, 0.8, 16).astype(np.float32)
            y = rng.uniform(-0.8, 0.8, 16).astype(np.float32)
            # view-space point on the slice -> world
            vx = x * depth * np.tan(0.5 * fov) * aspect
            vy = y * depth * np.tan(0.5 * fov)
            pv = np.stack([vx, vy, depth, np.ones_like(depth)], -1)
            inv_view = np.linalg.inv(cam.view)
            pw = (pv @ inv_view)[:, :3].astype(np.float32)
            ph = np.concatenate([pw, np.ones((16, 1), np.float32)], -1)
            uv_got = ph @ got.shadow_transforms[c]
            uv_want = ph @ want_t[c]
            uv_got = uv_got[:, :3] / uv_got[:, 3:4]
            uv_want = uv_want[:, :3] / uv_want[:, 3:4]
            np.testing.assert_allclose(
                uv_got[:, :2], uv_want[:, :2], atol=0.25 / S,
                err_msg=f"trial {trial} cascade {c} uv")
            np.testing.assert_allclose(
                uv_got[:, 2], uv_want[:, 2], atol=2e-4,
                err_msg=f"trial {trial} cascade {c} depth")
    assert compared >= 30, compared  # knife-edge skips must stay rare


def test_cascade_fit_snap_error_fails():
    """Sensitivity guard: shifting the snapped ortho center by ONE texel
    must trip the quarter-texel uv bound above (proves the tolerance is
    tight enough to catch a snapping bug)."""
    from crychic_renderer_tpu.models.camera import Camera

    S = 2048
    cam = Camera()
    cam.set_lens(0.25 * np.pi, 1.5, 1.0, 100.0)
    cam.look_at((0.0, 5.0, -12.0), (0.0, 0.0, 5.0), (0.0, 1.0, 0.0))
    light_dir = np.array([0.57735, -0.57735, 0.57735], np.float32)
    _, _, t0 = ho.UpdateCascadeShadowTransform(
        cam.view, cam.fov_y, cam.aspect, cam.near_z, cam.far_z,
        light_dir, S)
    # same fit with the center snapped one texel off in x: re-run the
    # oracle with width S' chosen so the floor lands one texel away is
    # fiddly; instead inject the error directly in uv space
    pw = np.array([[0.0, 0.0, 20.0, 1.0]], np.float32)
    uv = pw @ t0[0]
    uv_shifted = uv.copy()
    uv_shifted[:, 0] += uv[:, 3] * (1.0 / S)  # one-texel world-fit error
    with np.testing.assert_raises(AssertionError):
        np.testing.assert_allclose(
            (uv_shifted[:, :2] / uv_shifted[:, 3:4]),
            (uv[:, :2] / uv[:, 3:4]), atol=0.25 / S)


def test_gbuffer_codec_matches_oracle():
    """ops.gbuffer encode/decode == GBuffer.hlsl:22-43 at 200 random
    pixels, including the decode-side normal renormalization."""
    from crychic_renderer_tpu.ops import gbuffer

    rng = np.random.RandomState(37)
    N = 200
    pos = rng.uniform(-50, 50, (1, N, 3)).astype(np.float32)
    met = rng.uniform(0, 1, (1, N, 1)).astype(np.float32)
    alb = rng.uniform(0, 1, (1, N, 4)).astype(np.float32)
    rough = rng.uniform(0, 1, (1, N, 1)).astype(np.float32)
    nrm = (_unit(rng, N) * rng.uniform(0.5, 2.0, (N, 1))).astype(
        np.float32)[None]  # unnormalized: decode must renormalize

    gbs = [np.asarray(g) for g in gbuffer.encode(
        jnp.asarray(pos), jnp.asarray(met), jnp.asarray(alb),
        jnp.asarray(rough), jnp.asarray(nrm))]
    dec = {k: np.asarray(v) for k, v in gbuffer.decode(
        *[jnp.asarray(g) for g in gbs]).items()}

    for i in range(0, N, 7):
        w0, w1, w2, w3 = ho.EncodePBRToGBuffer(
            pos[0, i], met[0, i, 0], alb[0, i, :3], rough[0, i, 0],
            nrm[0, i])
        np.testing.assert_allclose(gbs[0][0, i], w0, rtol=1e-6)
        np.testing.assert_allclose(gbs[1][0, i], w1, rtol=1e-6)
        np.testing.assert_allclose(gbs[2][0, i], w2, rtol=1e-6)
        np.testing.assert_allclose(gbs[3][0, i], w3, rtol=1e-6)
        want = ho.DecodeGBuffer(w0, w1, w2, w3)
        np.testing.assert_allclose(dec["pos_w"][0, i], want["pos"],
                                   rtol=1e-6)
        np.testing.assert_allclose(dec["metalness"][0, i, 0],
                                   want["metalness"], rtol=1e-6)
        np.testing.assert_allclose(dec["albedo"][0, i], want["albedo"],
                                   rtol=1e-6)
        np.testing.assert_allclose(dec["roughness"][0, i, 0],
                                   want["roughness"], rtol=1e-6)
        np.testing.assert_allclose(dec["normal_w"][0, i], want["normal"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_composed_pixel_chain_matches_oracle():
    """END-TO-END composition check: one real
    config-5 frame, ~16 covered pixels, the full post-raster chain
    recomputed through the ORACLE — G-buffer encode/decode
    (EncodePBRToGBuffer/DecodeGBuffer), the cascade/PCF loop
    (CascadeShadowLoop on the frame's real shadow maps), PBR + tonemap +
    sky-reflection tail (DefaultPSTail) — against render_frame's final
    image. The per-map stages (SSAO occlusion/blur, PCF forms, PBR,
    tonemap) are oracle-verified as units above; this test verifies the
    GLUE: pass ordering, uv/projection plumbing, quirk flags.

    Boundaries (documented): ambient access is read from the frame's
    upsampled half-res map (its producer is unit-verified in
    test_ssao_*_matches_oracle), the procedural-sky reflection color is
    sampled by the production function at the ORACLE-computed reflection
    direction (the sky is a substitute for the missing reference asset,
    SURVEY §0), and the oracle reads the u16-dequantized shadow maps
    (+0.5 half-step) — the exact comparison contract pcf_single_tap
    implements (quantization itself is the production PCF's documented
    representation, verified in test_poisson_pcf_*)."""
    import dataclasses
    import functools

    import jax

    from crychic_renderer_tpu.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu.app.renderer import Renderer
    from crychic_renderer_tpu.ops import gbuffer, rasterizer as rz, sampling
    from crychic_renderer_tpu.passes import frame as fr

    scene_py, cfg, lights = CONFIGS[5]()
    cfg = dataclasses.replace(cfg, width=cfg.width // 8,
                              height=cfg.height // 8,
                              shadow_map_size=max(cfg.shadow_map_size // 8,
                                                  128))
    r = Renderer(scene_py, cfg, lights=lights)
    scene, consts, cfg = r.device_scene, r.frame_constants(0.0), r.cfg

    def intermediates(scene, consts):
        tris, tri_attr = fr.main_view_tris(scene, consts, cfg)
        bins = rz.bin_triangles(tris, cfg.width, cfg.height,
                                cfg.pair_capacity)
        depth, tid = rz.rasterize_binned(tris, bins, cfg.width,
                                         cfg.height, cfg.bin_cap)
        if cfg.alpha_test_enabled and scene.alpha is not None:
            depth, tid, tris, tri_attr = fr.alpha_merge_main(
                scene, consts, cfg, depth, tid, tris, tri_attr)
        g = fr.resolve_gbuffer(scene, consts, cfg, tris, depth, tid,
                               tri_attr)
        smaps = fr.render_shadow_maps(scene, consts, cfg)
        if cfg.alpha_test_enabled and scene.alpha is not None:
            smaps = fr.alpha_merge_shadow(scene, consts, cfg, smaps)
        access_half = fr.ssao_pass(scene, consts, cfg, g["normal_v"],
                                   depth)
        ambient = fr._upsample_bilinear(access_half, cfg.height,
                                        cfg.width)
        return g, smaps, ambient

    g, smaps, ambient = jax.jit(intermediates)(scene, consts)
    final = r.render_np(0.0)

    gb = [np.asarray(x) for x in gbuffer.from_resolve(g)]
    g_np = {k: np.asarray(v) for k, v in g.items()}
    smaps_np = np.asarray(smaps)
    # pcf_single_tap's exact comparison contract: u16 quantization with
    # the half-step offset (depth*65535 - 0.5 <= q  <=>  depth <= maps_eff)
    maps_eff = ((np.round(np.clip(smaps_np, 0.0, 1.0) * 65535.0)
                 + np.float32(0.5)) / np.float32(65535.0)).astype(
                     np.float32)
    ambient_np = np.asarray(ambient)
    eye = np.asarray(consts.eye_pos)
    xforms = np.asarray(consts.shadow_transforms)
    amb_light = np.asarray(scene.ambient)

    oracle_lights = []
    for i in range(cfg.num_dir_lights):
        oracle_lights.append(ho.Light(
            Strength=np.asarray(lights.strength[i], np.float32),
            FalloffStart=np.float32(1.0),
            Direction=np.asarray(lights.direction[i], np.float32),
            FalloffEnd=np.float32(10.0),
            Position=np.zeros(3, np.float32),
            SpotPower=np.float32(1.0)))

    # covered pixels spread over the cascade distances (and the screen)
    valid = g_np["valid"]
    dist = np.sqrt(((eye[None, None] - g_np["pos_w"]) ** 2).sum(-1))
    rng = np.random.RandomState(41)
    picks = []
    for lo, hi in [(0, 30), (30, 50), (50, 80), (80, 100), (0, 100)]:
        ys, xs = np.nonzero(valid & (dist >= lo) & (dist < hi))
        if len(ys) == 0:
            continue
        for j in rng.choice(len(ys), size=min(4, len(ys)), replace=False):
            picks.append((int(ys[j]), int(xs[j])))
    assert len(picks) >= 12, picks

    checked = 0
    for (y, x) in picks[:20]:
        desc = ho.DecodeGBuffer(gb[0][y, x], gb[1][y, x], gb[2][y, x],
                                gb[3][y, x])
        alb4 = np.concatenate([desc["albedo"],
                               [g_np["albedo"][y, x, 3]]]).astype(
                                   np.float32)
        met = desc["metalness"]
        fres_r0 = (np.float32(0.04) * (1 - met)
                   + desc["albedo"] * met).astype(np.float32)
        sf0 = ho.CascadeShadowLoop(maps_eff, xforms, eye,
                                   g_np["pos_w"][y, x], deferred=True)
        toEye = ho.normalize(eye - desc["pos"])
        refl = ho.reflect(-toEye, desc["normal"])
        cube = np.asarray(sampling.procedural_sky_color(
            jnp.asarray(refl)[None]))[0]
        cube4 = np.concatenate([cube, [np.float32(1.0)]]).astype(
            np.float32)
        want = ho.DefaultPSTail(
            diffuseAlbedo=alb4,
            normalMapSample=np.array([0, 0, 0, 1], np.float32),
            bumpedNormalW=desc["normal"], PosW=desc["pos"],
            gEyePosW=eye, ambientAccess=np.float32(ambient_np[y, x]),
            gAmbientLight=amb_light, fresnelR0=fres_r0,
            roughness=desc["roughness"], metalness=met,
            gLights=oracle_lights, num_dir=cfg.num_dir_lights,
            shadowFactor0=sf0, reflectionColor=cube4)
        # render_np clips to [0, 1] (display contract) — mirror it
        np.testing.assert_allclose(
            final[y, x], np.clip(want, 0.0, 1.0), rtol=2e-3, atol=2e-3,
            err_msg=f"pixel ({y},{x}) dist {dist[y, x]:.1f} sf0 {sf0}")
        checked += 1
    assert checked >= 12
