// Native asset pipeline: BC1/BC3 decode, Models/*.txt mesh parse, MSVC
// rand texture. The reference's asset path is native C++ end-to-end
// (Common/DDSTextureLoader.cpp, CRYCHIC::BuildSkullGeometry); this module
// keeps this renderer's host-side hot paths native too. Exposed via
// ctypes (see native/__init__.py), with pure-numpy fallbacks.
//
// Build: g++ -O3 -march=native -shared -fPIC asset_pipeline.cpp -o libcrychic_assets.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// BC1 (DXT1): 8-byte 4x4 blocks -> RGBA8
// ---------------------------------------------------------------------------

static inline void decode565(uint16_t c, float* rgb) {
    rgb[0] = ((c >> 11) & 0x1F) * (255.0f / 31.0f);
    rgb[1] = ((c >> 5) & 0x3F) * (255.0f / 63.0f);
    rgb[2] = (c & 0x1F) * (255.0f / 31.0f);
}

static inline uint8_t clamp255(float v) {
    v += 0.5f;
    if (v < 0.0f) return 0;
    if (v > 255.0f) return 255;
    return (uint8_t)v;
}

void decode_bc1(const uint8_t* data, int width, int height, uint8_t* out) {
    const int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* blk = data + (by * bw + bx) * 8;
            uint16_t c0 = blk[0] | (blk[1] << 8);
            uint16_t c1 = blk[2] | (blk[3] << 8);
            uint32_t bits = blk[4] | (blk[5] << 8) | (blk[6] << 16)
                            | ((uint32_t)blk[7] << 24);
            float p[4][4];
            decode565(c0, p[0]);
            decode565(c1, p[1]);
            p[0][3] = p[1][3] = 255.0f;
            if (c0 > c1) {
                for (int k = 0; k < 3; ++k) {
                    p[2][k] = (2 * p[0][k] + p[1][k]) / 3.0f;
                    p[3][k] = (p[0][k] + 2 * p[1][k]) / 3.0f;
                }
                p[2][3] = p[3][3] = 255.0f;
            } else {
                for (int k = 0; k < 3; ++k) {
                    p[2][k] = 0.5f * (p[0][k] + p[1][k]);
                    p[3][k] = 0.0f;
                }
                p[2][3] = 255.0f;
                p[3][3] = 0.0f;
            }
            for (int t = 0; t < 16; ++t) {
                int px = bx * 4 + (t & 3), py = by * 4 + (t >> 2);
                if (px >= width || py >= height) continue;
                const float* col = p[(bits >> (2 * t)) & 3];
                uint8_t* o = out + (py * width + px) * 4;
                o[0] = clamp255(col[0]);
                o[1] = clamp255(col[1]);
                o[2] = clamp255(col[2]);
                o[3] = clamp255(col[3]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// BC2 (DXT3): 16-byte blocks (8 explicit 4-bit alpha + 8 color) -> RGBA8
// ---------------------------------------------------------------------------

void decode_bc2(const uint8_t* data, int width, int height, uint8_t* out) {
    const int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* blk = data + (by * bw + bx) * 16;
            const uint8_t* cb = blk + 8;
            uint16_t c0 = cb[0] | (cb[1] << 8);
            uint16_t c1 = cb[2] | (cb[3] << 8);
            uint32_t bits = cb[4] | (cb[5] << 8) | (cb[6] << 16)
                            | ((uint32_t)cb[7] << 24);
            float p[4][3];
            decode565(c0, p[0]);
            decode565(c1, p[1]);
            for (int k = 0; k < 3; ++k) {
                p[2][k] = (2 * p[0][k] + p[1][k]) / 3.0f;
                p[3][k] = (p[0][k] + 2 * p[1][k]) / 3.0f;
            }
            for (int t = 0; t < 16; ++t) {
                int px = bx * 4 + (t & 3), py = by * 4 + (t >> 2);
                if (px >= width || py >= height) continue;
                const float* col = p[(bits >> (2 * t)) & 3];
                uint8_t nib = (blk[t >> 1] >> ((t & 1) * 4)) & 0xF;
                uint8_t* o = out + (py * width + px) * 4;
                o[0] = clamp255(col[0]);
                o[1] = clamp255(col[1]);
                o[2] = clamp255(col[2]);
                o[3] = clamp255(nib * (255.0f / 15.0f));
            }
        }
    }
}

// ---------------------------------------------------------------------------
// BC3 (DXT5): 16-byte blocks (8 alpha + 8 color) -> RGBA8
// ---------------------------------------------------------------------------

void decode_bc3(const uint8_t* data, int width, int height, uint8_t* out) {
    const int bw = (width + 3) / 4, bh = (height + 3) / 4;
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* blk = data + (by * bw + bx) * 16;
            float a0 = blk[0], a1 = blk[1];
            uint64_t abits = 0;
            for (int i = 0; i < 6; ++i)
                abits |= (uint64_t)blk[2 + i] << (8 * i);
            float apal[8];
            apal[0] = a0;
            apal[1] = a1;
            if (a0 > a1) {
                for (int i = 1; i < 7; ++i)
                    apal[i + 1] = ((7 - i) * a0 + i * a1) / 7.0f;
            } else {
                for (int i = 1; i < 5; ++i)
                    apal[i + 1] = ((5 - i) * a0 + i * a1) / 5.0f;
                apal[6] = 0.0f;
                apal[7] = 255.0f;
            }
            const uint8_t* cb = blk + 8;
            uint16_t c0 = cb[0] | (cb[1] << 8);
            uint16_t c1 = cb[2] | (cb[3] << 8);
            uint32_t bits = cb[4] | (cb[5] << 8) | (cb[6] << 16)
                            | ((uint32_t)cb[7] << 24);
            float p[4][3];
            decode565(c0, p[0]);
            decode565(c1, p[1]);
            for (int k = 0; k < 3; ++k) {
                p[2][k] = (2 * p[0][k] + p[1][k]) / 3.0f;
                p[3][k] = (p[0][k] + 2 * p[1][k]) / 3.0f;
            }
            for (int t = 0; t < 16; ++t) {
                int px = bx * 4 + (t & 3), py = by * 4 + (t >> 2);
                if (px >= width || py >= height) continue;
                const float* col = p[(bits >> (2 * t)) & 3];
                float alpha = apal[(abits >> (3 * t)) & 7];
                uint8_t* o = out + (py * width + px) * 4;
                o[0] = clamp255(col[0]);
                o[1] = clamp255(col[1]);
                o[2] = clamp255(col[2]);
                o[3] = clamp255(alpha);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Models/*.txt parser (skull/car format — CRYCHIC.cpp:1447-1516 semantics)
// ---------------------------------------------------------------------------

// First pass: return vertex / triangle counts (<0 on error).
int mesh_txt_counts(const char* path, int* vcount, int* tcount) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char key[128];
    if (fscanf(f, "%127s %d", key, vcount) != 2) { fclose(f); return -2; }
    if (fscanf(f, "%127s %d", key, tcount) != 2) { fclose(f); return -3; }
    fclose(f);
    return 0;
}

// Second pass: fill positions+normals (vcount*6 floats) and indices
// (tcount*3 int32). Returns 0 on success.
int mesh_txt_parse(const char* path, float* pos_nrm, int vcount,
                   int32_t* indices, int tcount) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    // skip header tokens until '{'
    int c;
    int braces = 0;
    char tok[256];
    // read 4 header tokens: VertexCount: N TriangleCount: M
    for (int i = 0; i < 4; ++i) fscanf(f, "%255s", tok);
    while ((c = fgetc(f)) != EOF && c != '{') {}
    for (int i = 0; i < vcount * 6; ++i) {
        if (fscanf(f, "%f", pos_nrm + i) != 1) { fclose(f); return -2; }
    }
    while ((c = fgetc(f)) != EOF && c != '{') {}
    for (int i = 0; i < tcount * 3; ++i) {
        if (fscanf(f, "%d", indices + i) != 1) { fclose(f); return -3; }
    }
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// MSVC rand() replication (SSAO random-vector texture, Ssao.cpp:392-402)
// ---------------------------------------------------------------------------

void msvc_random_texture(float* out_rgb, int size, uint32_t seed,
                         int skip_draws) {
    uint32_t state = seed;
    auto next = [&state]() {
        state = state * 214013u + 2531011u;
        return (state >> 16) & 0x7FFF;
    };
    for (int i = 0; i < skip_draws; ++i) next();
    const float inv = 1.0f / 32767.0f;
    for (int i = 0; i < size * size * 3; ++i) {
        float v = next() * inv;
        out_rgb[i] = roundf(v * 255.0f) / 255.0f;
    }
}

}  // extern "C"
