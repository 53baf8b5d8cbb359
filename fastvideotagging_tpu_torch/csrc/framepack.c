/* fvt_native: host data-plane kernels for the clip loader.
 *
 * The port's copy of the JAX package's native/framepack.c, arithmetic
 * unchanged: assembling clip batches from decoded frames (fvt_pack_frames)
 * and the host resize to the ship geometry (fvt_resize_batch_u8). Built at
 * first use with `cc -O3 -march=native -shared -fPIC ... -lm`, the flags of
 * the JAX package's build, and bound through ctypes (native/__init__.py);
 * there is no numpy fallback in the port.
 *
 * The resize follows the framework's bilinear spec in float (half-pixel
 * centers, data/preprocess.py::resize_coeffs), quantized to u8 by lrintf,
 * which rounds in the current rounding mode: half to even by default. Its
 * results equal the JAX package's C tier bit for bit only under the same
 * flags: -march=native lets the compiler contract (1 - f) * a + f * b into
 * fused multiply-adds (gcc's default -ffp-contract=fast), and other flags
 * round elsewhere.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

#define FVT_API __attribute__((visibility("default")))

/* Gather frames at idx[i] from a contiguous (n_frames, frame_bytes) buffer
 * into dst (n_idx, frame_bytes). Out-of-range indices clamp to the last
 * frame (mirrors decode.read_frames_at's fill policy). */
FVT_API void fvt_pack_frames(const uint8_t *src, int64_t n_frames,
                             const int64_t *idx, int64_t n_idx,
                             int64_t frame_bytes, uint8_t *dst) {
    for (int64_t i = 0; i < n_idx; ++i) {
        int64_t j = idx[i];
        if (j < 0) j = 0;
        if (j >= n_frames) j = n_frames - 1;
        memcpy(dst + i * frame_bytes, src + j * frame_bytes,
               (size_t)frame_bytes);
    }
}

static void build_axis(int64_t src, int64_t dst, int32_t *lo, int32_t *hi,
                       float *frac) {
    double scale = (double)src / (double)dst;
    for (int64_t i = 0; i < dst; ++i) {
        double x = ((double)i + 0.5) * scale - 0.5;
        if (x < 0.0) x = 0.0;
        if (x > (double)(src - 1)) x = (double)(src - 1);
        int64_t l = (int64_t)floor(x);
        int64_t h = l + 1 < src ? l + 1 : src - 1;
        lo[i] = (int32_t)l;
        hi[i] = (int32_t)h;
        frac[i] = (float)(x - (double)l);
    }
}

/* Bilinear resize of T HWC u8 frames: (t, h0, w0, 3) -> (t, h1, w1, 3). */
FVT_API int fvt_resize_batch_u8(const uint8_t *src, int64_t t, int64_t h0,
                                int64_t w0, uint8_t *dst, int64_t h1,
                                int64_t w1) {
    int32_t *ylo = malloc(sizeof(int32_t) * h1), *yhi = malloc(sizeof(int32_t) * h1);
    int32_t *xlo = malloc(sizeof(int32_t) * w1), *xhi = malloc(sizeof(int32_t) * w1);
    float *yf = malloc(sizeof(float) * h1), *xf = malloc(sizeof(float) * w1);
    float *row = malloc(sizeof(float) * w0 * 3 * 2);
    if (!ylo || !yhi || !xlo || !xhi || !yf || !xf || !row) {
        free(ylo); free(yhi); free(xlo); free(xhi); free(yf); free(xf); free(row);
        return -1;
    }
    build_axis(h0, h1, ylo, yhi, yf);
    build_axis(w0, w1, xlo, xhi, xf);

    const int64_t src_frame = h0 * w0 * 3, dst_frame = h1 * w1 * 3;
    for (int64_t f = 0; f < t; ++f) {
        const uint8_t *sf = src + f * src_frame;
        uint8_t *df = dst + f * dst_frame;
        for (int64_t y = 0; y < h1; ++y) {
            const uint8_t *r0 = sf + (int64_t)ylo[y] * w0 * 3;
            const uint8_t *r1 = sf + (int64_t)yhi[y] * w0 * 3;
            const float fy = yf[y];
            /* vertical lerp into a float row buffer */
            for (int64_t x = 0; x < w0 * 3; ++x)
                row[x] = (1.0f - fy) * (float)r0[x] + fy * (float)r1[x];
            uint8_t *out = df + y * w1 * 3;
            for (int64_t x = 0; x < w1; ++x) {
                const float fx = xf[x];
                const float *p0 = row + (int64_t)xlo[x] * 3;
                const float *p1 = row + (int64_t)xhi[x] * 3;
                for (int c = 0; c < 3; ++c) {
                    float v = (1.0f - fx) * p0[c] + fx * p1[c];
                    long q = lrintf(v);
                    if (q < 0) q = 0;
                    if (q > 255) q = 255;
                    out[x * 3 + c] = (uint8_t)q;
                }
            }
        }
    }
    free(ylo); free(yhi); free(xlo); free(xhi); free(yf); free(xf); free(row);
    return 0;
}
