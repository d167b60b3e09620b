// Native runtime components for tinypathtracer_tpu.
//
// The reference implements its entire host runtime in C++ (scene
// loading mesh.cu, image decode picture.h, BVH build bvh.cu). This
// framework keeps the device compute path in XLA, and provides the
// host-side runtime roles natively here:
//
//   * tpt_b64_decode      -- base64 buffer decode for glTF data URIs
//                            (the hot part of asset loading)
//   * tpt_build_lbvh      -- host LBVH builder (morton + sort + Karras
//                            + bottom-up AABB fit), same topology rules
//                            as ops/lbvh.py: 30-bit scene-normalized
//                            morton codes with sorted-index tiebreak,
//                            internal nodes [0, F-1), leaves [F-1, 2F-1)
//
// Built as a plain shared library; Python binds via ctypes
// (utils/native.py). No Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// base64 decode. Returns number of bytes written, or -1 on bad input.
// Accepts standard alphabet with optional '=' padding; skips whitespace.
// ---------------------------------------------------------------------------
long long tpt_b64_decode(const char* in, long long n, unsigned char* out) {
    static signed char lut[256];
    static bool init = false;
    if (!init) {
        std::memset(lut, -1, sizeof(lut));
        const char* alpha =
            "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
        for (int i = 0; i < 64; ++i) lut[(unsigned char)alpha[i]] = (signed char)i;
        init = true;
    }
    long long w = 0;
    unsigned int acc = 0;
    int bits = 0;
    for (long long i = 0; i < n; ++i) {
        unsigned char c = (unsigned char)in[i];
        if (c == '=' || c == '\n' || c == '\r' || c == ' ' || c == '\t') continue;
        signed char v = lut[c];
        if (v < 0) return -1;
        acc = (acc << 6) | (unsigned int)v;
        bits += 6;
        if (bits >= 8) {
            bits -= 8;
            out[w++] = (unsigned char)((acc >> bits) & 0xFF);
        }
    }
    return w;
}

// ---------------------------------------------------------------------------
// Host LBVH build.
// tri_verts: [F, 3, 3] float32 (face-major). Outputs (caller-allocated):
//   left,right: [max(F-1,1)] int32; parent: [2F-1] int32;
//   leaf_fid: [F] int32; bmin,bmax: [2F-1, 3] float32.
// ---------------------------------------------------------------------------
namespace {

inline uint32_t expand_bits10(uint32_t x) {
    x = (x | (x << 16)) & 0x030000FFu;
    x = (x | (x << 8)) & 0x0300F00Fu;
    x = (x | (x << 4)) & 0x030C30C3u;
    x = (x | (x << 2)) & 0x09249249u;
    return x;
}

inline int clz32(uint32_t x) {
    if (x == 0) return 32;
#if defined(__GNUC__)
    return __builtin_clz(x);
#else
    int n = 0;
    while (!(x & 0x80000000u)) { x <<= 1; ++n; }
    return n;
#endif
}

struct DeltaCtx {
    const uint32_t* codes;
    int f;
    // common-prefix length with sorted-index tiebreak (ops/lbvh.py)
    int operator()(int i, int j) const {
        if (j < 0 || j >= f) return -1;
        uint32_t x = codes[i] ^ codes[j];
        if (x == 0) return 32 + clz32((uint32_t)(i ^ j));
        return clz32(x);
    }
};

}  // namespace

int tpt_build_lbvh(const float* tri_verts, int f,
                   int32_t* left, int32_t* right, int32_t* parent,
                   int32_t* leaf_fid, float* bmin, float* bmax) {
    if (f <= 0) return -1;
    const int n_nodes = 2 * f - 1;

    std::vector<float> fb_min(3 * f), fb_max(3 * f);
    float smin[3] = {1e30f, 1e30f, 1e30f}, smax[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < f; ++i) {
        for (int a = 0; a < 3; ++a) {
            float lo = tri_verts[(i * 3 + 0) * 3 + a];
            float hi = lo;
            for (int v = 1; v < 3; ++v) {
                float x = tri_verts[(i * 3 + v) * 3 + a];
                lo = std::min(lo, x);
                hi = std::max(hi, x);
            }
            fb_min[3 * i + a] = lo;
            fb_max[3 * i + a] = hi;
            smin[a] = std::min(smin[a], lo);
            smax[a] = std::max(smax[a], hi);
        }
    }

    std::vector<uint32_t> codes(f);
    for (int i = 0; i < f; ++i) {
        uint32_t q[3];
        for (int a = 0; a < 3; ++a) {
            float ext = std::max(smax[a] - smin[a], 1e-12f);
            float c = 0.5f * (fb_min[3 * i + a] + fb_max[3 * i + a]);
            float t = (c - smin[a]) / ext;
            int qi = (int)(t * 1024.0f);
            q[a] = (uint32_t)std::min(std::max(qi, 0), 1023);
        }
        codes[i] = expand_bits10(q[0]) | (expand_bits10(q[1]) << 1)
                 | (expand_bits10(q[2]) << 2);
    }

    std::vector<int32_t> order(f);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return codes[a] < codes[b]; });
    std::vector<uint32_t> sorted(f);
    for (int i = 0; i < f; ++i) {
        sorted[i] = codes[order[i]];
        leaf_fid[i] = order[i];
    }

    // leaf boxes into node space [f-1, 2f-1)
    for (int i = 0; i < f; ++i) {
        int fid = order[i];
        for (int a = 0; a < 3; ++a) {
            bmin[3 * (f - 1 + i) + a] = fb_min[3 * fid + a];
            bmax[3 * (f - 1 + i) + a] = fb_max[3 * fid + a];
        }
    }
    for (int i = 0; i < n_nodes; ++i) parent[i] = -1;

    if (f == 1) {
        left[0] = right[0] = 0;
        return 0;
    }

    DeltaCtx delta{sorted.data(), f};
    for (int i = 0; i < f - 1; ++i) {
        int d = (delta(i, i + 1) >= delta(i, i - 1)) ? 1 : -1;
        int delta_min = delta(i, i - d);
        int lmax = 2;
        while (delta(i, i + lmax * d) > delta_min) lmax <<= 1;
        int l = 0;
        for (int t = lmax >> 1; t > 0; t >>= 1)
            if (delta(i, i + (l + t) * d) > delta_min) l += t;
        int j = i + l * d;
        int delta_node = delta(i, j);
        int s = 0;
        for (int t = (l + 1) >> 1; t > 0; t = (t > 1) ? (t + 1) >> 1 : 0) {
            if (delta(i, i + (s + t) * d) > delta_node) s += t;
            if (t == 1) break;
        }
        int gamma = i + s * d + std::min(d, 0);
        int lo = std::min(i, j), hi = std::max(i, j);
        int lc = (lo == gamma) ? gamma + (f - 1) : gamma;
        int rc = (hi == gamma + 1) ? gamma + f : gamma + 1;
        left[i] = lc;
        right[i] = rc;
        parent[lc] = i;
        parent[rc] = i;
    }

    // bottom-up AABB fit: iterative post-order via explicit stack
    std::vector<int32_t> stack;
    std::vector<uint8_t> done(f - 1, 0);
    stack.push_back(0);
    while (!stack.empty()) {
        int node = stack.back();
        if (node >= f - 1) { stack.pop_back(); continue; }
        if (done[node]) {
            stack.pop_back();
            int lc = left[node], rc = right[node];
            for (int a = 0; a < 3; ++a) {
                bmin[3 * node + a] = std::min(bmin[3 * lc + a], bmin[3 * rc + a]);
                bmax[3 * node + a] = std::max(bmax[3 * lc + a], bmax[3 * rc + a]);
            }
        } else {
            done[node] = 1;
            stack.push_back(left[node]);
            stack.push_back(right[node]);
        }
    }
    return 0;
}

}  // extern "C"
