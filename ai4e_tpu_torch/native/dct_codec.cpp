// DCT-truncation host-side encoder of the dct wire
// (ai4e_tpu_torch/ops/dct.py); a copy of the JAX package's
// native/dct_codec.cpp. It converts color, subsamples chroma and does the
// two small products per block in one pass of scalar float math the
// compiler auto-vectorizes; preprocess runs per request on the serving
// host.
//
// Contract matches the Python reference (ops/dct.py):
//   color:   JPEG/JFIF full-range BT.601 (identical constants), planes
//            level-shifted by -128, chroma 2x2 box mean;
//   blocks:  orthonormal DCT-II basis B (row 0 scaled by 1/sqrt(2)),
//            coef = B[:K] @ block @ B[:K]^T, top-left K x K kept;
//   quant:   round(coef / q) clipped to [-127, 127] as int8, with
//            round-half-to-even (nearbyintf under the default FP mode —
//            the same tie rule numpy's np.round uses);
//   layout:  [Y (h/8 * w/8 * K*K)] [Cb (h/16 * w/16 * K*K)] [Cr ...],
//            each plane's blocks row-major, each block row-major.
// Quant tables are PASSED IN (computed once by ops/dct.py's quant_tables)
// so the scaling/clamping rules live in exactly one place.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Orthonormal DCT-II basis, computed once (double then narrowed — matches
// numpy's float64 cos path narrowed to float32).
struct Basis {
    float b[8][8];
    Basis() {
        const double invsqrt2 = 1.0 / std::sqrt(2.0);
        for (int k = 0; k < 8; ++k) {
            for (int n = 0; n < 8; ++n) {
                double v = std::cos(M_PI * (2 * n + 1) * k / 16.0)
                           * std::sqrt(2.0 / 8.0);
                if (k == 0) v *= invsqrt2;
                b[k][n] = (float)v;
            }
        }
    }
};
const Basis kBasis;

// One plane (level-shifted floats) -> quantized K x K coefficients per
// 8 x 8 block, appended row-major.
void plane_to_coeffs(const float* plane, int ph, int pw, int k,
                     const float* qtable, int8_t* out) {
    const int hb = ph / 8, wb = pw / 8;
    float tmp[8][8];   // B[:k] @ block  (only rows < k used)
    for (int by = 0; by < hb; ++by) {
        for (int bx = 0; bx < wb; ++bx) {
            const float* blk = plane + (size_t)by * 8 * pw + (size_t)bx * 8;
            for (int r = 0; r < k; ++r) {
                for (int c = 0; c < 8; ++c) {
                    float acc = 0.0f;
                    for (int a = 0; a < 8; ++a)
                        acc += kBasis.b[r][a] * blk[(size_t)a * pw + c];
                    tmp[r][c] = acc;
                }
            }
            int8_t* dst = out + ((size_t)by * wb + bx) * k * k;
            for (int r = 0; r < k; ++r) {
                for (int l = 0; l < k; ++l) {
                    float acc = 0.0f;
                    for (int c = 0; c < 8; ++c)
                        acc += tmp[r][c] * kBasis.b[l][c];
                    float q = nearbyintf(acc / qtable[r * k + l]);
                    q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
                    dst[r * k + l] = (int8_t)q;
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// rgb: h*w*3 interleaved uint8; luma_q/chroma_q: k*k float tables;
// out: dct_nbytes(h, w, k) int8. h, w divisible by 16 (wrapper validates).
// Returns 0 on ok.
int dct_encode(const uint8_t* rgb, int h, int w, int k,
               const float* luma_q, const float* chroma_q, int8_t* out) {
    if (h <= 0 || w <= 0 || (h % 16) || (w % 16) || k < 1 || k > 8)
        return 1;
    const int ch = h / 2, cw = w / 2;
    std::vector<float> y((size_t)h * w);
    std::vector<float> cb((size_t)ch * cw), cr((size_t)ch * cw);
    for (int by = 0; by < h; by += 2) {
        const uint8_t* row0 = rgb + (size_t)by * w * 3;
        const uint8_t* row1 = row0 + (size_t)w * 3;
        float* y0 = y.data() + (size_t)by * w;
        float* y1 = y0 + w;
        float* cbrow = cb.data() + (size_t)(by / 2) * cw;
        float* crrow = cr.data() + (size_t)(by / 2) * cw;
        for (int bx = 0; bx < w; bx += 2) {
            const uint8_t* p[4] = {row0 + (size_t)bx * 3,
                                   row0 + (size_t)(bx + 1) * 3,
                                   row1 + (size_t)bx * 3,
                                   row1 + (size_t)(bx + 1) * 3};
            float cbs = 0.0f, crs = 0.0f;
            for (int i = 0; i < 4; ++i) {
                const float r = (float)p[i][0], g = (float)p[i][1],
                            b = (float)p[i][2];
                const float yy = 0.299f * r + 0.587f * g + 0.114f * b;
                // Level shift here so the block transform sees [-128, 127].
                const float lum = yy - 128.0f;
                if (i == 0) y0[bx] = lum;
                else if (i == 1) y0[bx + 1] = lum;
                else if (i == 2) y1[bx] = lum;
                else y1[bx + 1] = lum;
                cbs += -0.168736f * r - 0.331264f * g + 0.5f * b;
                crs += 0.5f * r - 0.418688f * g - 0.081312f * b;
            }
            // mean of the four per-pixel chroma values; the +128/-128
            // level-shift pair cancels.
            cbrow[bx / 2] = cbs * 0.25f;
            crrow[bx / 2] = crs * 0.25f;
        }
    }
    const size_t n_y = (size_t)(h / 8) * (w / 8) * k * k;
    const size_t n_c = (size_t)(ch / 8) * (cw / 8) * k * k;
    plane_to_coeffs(y.data(), h, w, k, luma_q, out);
    plane_to_coeffs(cb.data(), ch, cw, k, chroma_q, out + n_y);
    plane_to_coeffs(cr.data(), ch, cw, k, chroma_q, out + n_y + n_c);
    return 0;
}

}  // extern "C"
