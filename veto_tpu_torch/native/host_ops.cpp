// Native host-side image ops for the veto_tpu_torch data loader (a copy of
// the JAX package's veto_tpu/native/host_ops.cpp; the port builds its own).
//
// The host-side hot loop of the loader is the image pipeline: bilinear
// resize (the PIL
// triangle-filter resampling, Resize/transforms.py:27-63), BGR*255
// normalization (Normalize:112-124) and pad-to-bucket (ImageList
// image_list.py:29-72).  This library fuses them in C++ with OpenMP so a
// single host core is no longer the loader bottleneck.
//
// Exact-match notes: the resize reproduces PIL's `resize(..., BILINEAR)`
// resampling (triangle filter, support scaled by the downscale ratio,
// per-output-pixel normalized coefficient windows) so outputs are
// numerically interchangeable with the PIL path.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17 host_ops.cpp -o <lib>
// (driven by veto_tpu_torch/native/__init__.py at first use, into the
// git-ignored build/ at the repo root, with a NumPy fallback if no compiler
// is available).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// PIL-style separable triangle resampling (one axis)
// ---------------------------------------------------------------------
static void precompute_coeffs(int in_size, int out_size,
                              std::vector<int>& bounds,
                              std::vector<double>& kk, int& ksize) {
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // triangle filter support = 1
    ksize = (int)ceil(support) * 2 + 1;

    bounds.resize(out_size * 2);
    kk.resize(out_size * ksize);

    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &kk[xx * ksize];
        int x = 0;
        for (; x < xmax; x++) {
            double w = (x + xmin - center + 0.5) * ss;
            // triangle (bilinear) kernel
            w = w < 0 ? -w : w;
            w = w < 1.0 ? 1.0 - w : 0.0;
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) k[x] /= ww;
        }
        for (; x < ksize; x++) k[x] = 0.0;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
}

// resize (h, w, c) float32 → (oh, ow, c) float32, PIL BILINEAR semantics
void resize_bilinear_f32(const float* src, int h, int w, int c,
                         float* dst, int oh, int ow) {
    std::vector<int> xb, yb;
    std::vector<double> xk, yk;
    int xks, yks;
    precompute_coeffs(w, ow, xb, xk, xks);
    precompute_coeffs(h, oh, yb, yk, yks);

    // horizontal pass: (h, w, c) → (h, ow, c)
    std::vector<float> tmp((size_t)h * ow * c);
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; y++) {
        const float* row = src + (size_t)y * w * c;
        float* orow = &tmp[(size_t)y * ow * c];
        for (int x = 0; x < ow; x++) {
            int xmin = xb[x * 2], xmax = xb[x * 2 + 1];
            const double* k = &xk[x * xks];
            for (int ch = 0; ch < c; ch++) {
                double acc = 0.0;
                for (int i = 0; i < xmax; i++)
                    acc += row[(size_t)(xmin + i) * c + ch] * k[i];
                orow[(size_t)x * c + ch] = (float)acc;
            }
        }
    }
    // vertical pass: (h, ow, c) → (oh, ow, c).  Row-accumulation order:
    // each contributing row streams sequentially instead of strided
    // per-pixel tap reads.
#pragma omp parallel for schedule(static)
    for (int y = 0; y < oh; y++) {
        int ymin = yb[y * 2], ymax = yb[y * 2 + 1];
        const double* k = &yk[y * yks];
        float* orow = dst + (size_t)y * ow * c;
        const int n = ow * c;
        for (int j = 0; j < n; j++) orow[j] = 0.0f;
        for (int i = 0; i < ymax; i++) {
            const float kf = (float)k[i];
            const float* row = &tmp[(size_t)(ymin + i) * ow * c];
            for (int j = 0; j < n; j++) orow[j] += row[j] * kf;
        }
    }
}

// RGB float[0,1] (h, w, 3) → normalized BGR*255, zero-padded to (ph, pw, 3)
void normalize_bgr255_pad(const float* src, int h, int w,
                          float* dst, int ph, int pw,
                          const float* mean, const float* stdv,
                          int to_bgr255) {
    memset(dst, 0, (size_t)ph * pw * 3 * sizeof(float));
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; y++) {
        const float* row = src + (size_t)y * w * 3;
        float* orow = dst + (size_t)y * pw * 3;
        for (int x = 0; x < w; x++) {
            for (int ch = 0; ch < 3; ch++) {
                float v = to_bgr255 ? row[x * 3 + (2 - ch)] * 255.0f
                                    : row[x * 3 + ch];
                orow[x * 3 + ch] = (v - mean[ch]) / stdv[ch];
            }
        }
    }
}

// depth (h, w, 1): per-image standardize with 1/sqrt(h*w) std floor,
// zero-padded to (ph, pw, 1)  (DepthNormalize, transforms.py:127-149)
void standardize_pad(const float* src, int h, int w,
                     float* dst, int ph, int pw) {
    size_t n = (size_t)h * w;
    double sum = 0.0, sq = 0.0;
#pragma omp parallel for reduction(+:sum, sq) schedule(static)
    for (long i = 0; i < (long)n; i++) {
        double v = src[i];
        sum += v;
        sq += v * v;
    }
    double mean = sum / n;
    double var = sq / n - mean * mean;
    double stdv = var > 0 ? sqrt(var) : 0.0;
    double floorv = 1.0 / sqrt((double)n);
    if (stdv < floorv) stdv = floorv;

    memset(dst, 0, (size_t)ph * pw * sizeof(float));
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; y++) {
        const float* row = src + (size_t)y * w;
        float* orow = dst + (size_t)y * pw;
        for (int x = 0; x < w; x++)
            orow[x] = (float)((row[x] - mean) / stdv);
    }
}

// ---------------------------------------------------------------------
// Fused loader paths: one call from decoded bytes to the padded,
// normalized batch slot.  Exactness: the [0,1] float pipeline computes
// resize(u8/255)*255 - mean; resize is linear, so this equals
// resize(u8) - mean — operating on the raw u8 values directly saves the
// /255 float conversion, the *255 normalize pass, and two intermediate
// image-sized copies per image.
// ---------------------------------------------------------------------

// u8 RGB (h, w, 3) → resize (PIL BILINEAR) → BGR − mean)/std → write into
// a (ph, pw, 3) float32 destination (zero-padded bottom/right)
void resize_normalize_u8_pad(const unsigned char* src, int h, int w,
                             float* dst, int oh, int ow, int ph, int pw,
                             const float* mean, const float* stdv,
                             int to_bgr255) {
    std::vector<int> xb, yb;
    std::vector<double> xk, yk;
    int xks, yks;
    precompute_coeffs(w, ow, xb, xk, xks);
    precompute_coeffs(h, oh, yb, yk, yks);

    // horizontal pass on the u8 rows: (h, w, 3) → (h, ow, 3) float
    std::vector<float> tmp((size_t)h * ow * 3);
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; y++) {
        const unsigned char* row = src + (size_t)y * w * 3;
        float* orow = &tmp[(size_t)y * ow * 3];
        for (int x = 0; x < ow; x++) {
            int xmin = xb[x * 2], xmax = xb[x * 2 + 1];
            const double* k = &xk[x * xks];
            double a0 = 0.0, a1 = 0.0, a2 = 0.0;
            for (int i = 0; i < xmax; i++) {
                const unsigned char* p = row + (size_t)(xmin + i) * 3;
                a0 += p[0] * k[i];
                a1 += p[1] * k[i];
                a2 += p[2] * k[i];
            }
            orow[(size_t)x * 3 + 0] = (float)a0;
            orow[(size_t)x * 3 + 1] = (float)a1;
            orow[(size_t)x * 3 + 2] = (float)a2;
        }
    }
    memset(dst, 0, (size_t)ph * pw * 3 * sizeof(float));
    // vertical pass + channel swap + mean/std, straight into the slot.
    // Row-accumulation order: for each tap, stream the whole contributing
    // row sequentially (cache-friendly; the per-pixel tap loop above reads
    // with stride ow*3).
#pragma omp parallel for schedule(static)
    for (int y = 0; y < oh; y++) {
        int ymin = yb[y * 2], ymax = yb[y * 2 + 1];
        const double* k = &yk[y * yks];
        std::vector<float> acc((size_t)ow * 3, 0.0f);
        for (int i = 0; i < ymax; i++) {
            const float kf = (float)k[i];
            const float* row = &tmp[(size_t)(ymin + i) * ow * 3];
            float* a = acc.data();
            for (int j = 0; j < ow * 3; j++) a[j] += row[j] * kf;
        }
        float* orow = dst + (size_t)y * pw * 3;
        if (to_bgr255) {  // RGB accumulators → BGR output order
            for (int x = 0; x < ow; x++) {
                orow[x * 3 + 0] = (acc[x * 3 + 2] - mean[0]) / stdv[0];
                orow[x * 3 + 1] = (acc[x * 3 + 1] - mean[1]) / stdv[1];
                orow[x * 3 + 2] = (acc[x * 3 + 0] - mean[2]) / stdv[2];
            }
        } else {
            for (int x = 0; x < ow; x++)
                for (int ch = 0; ch < 3; ch++)
                    orow[x * 3 + ch] = (acc[x * 3 + ch] - mean[ch]) / stdv[ch];
        }
    }
}

// depth float32 (h, w) → resize → per-image standardize (of the RESIZED
// map, matching normalize_depth(resize_image(...))) → (ph, pw) slot
void resize_standardize_pad(const float* src, int h, int w,
                            float* dst, int oh, int ow, int ph, int pw) {
    std::vector<float> resized((size_t)oh * ow);
    resize_bilinear_f32(src, h, w, 1, resized.data(), oh, ow);

    size_t n = (size_t)oh * ow;
    double sum = 0.0, sq = 0.0;
#pragma omp parallel for reduction(+:sum, sq) schedule(static)
    for (long i = 0; i < (long)n; i++) {
        double v = resized[i];
        sum += v;
        sq += v * v;
    }
    double mean = sum / n;
    double var = sq / n - mean * mean;
    double stdv = var > 0 ? sqrt(var) : 0.0;
    double floorv = 1.0 / sqrt((double)n);
    if (stdv < floorv) stdv = floorv;

    memset(dst, 0, (size_t)ph * pw * sizeof(float));
#pragma omp parallel for schedule(static)
    for (int y = 0; y < oh; y++) {
        const float* row = &resized[(size_t)y * ow];
        float* orow = dst + (size_t)y * pw;
        for (int x = 0; x < ow; x++)
            orow[x] = (float)((row[x] - mean) / stdv);
    }
}

}  // extern "C"
