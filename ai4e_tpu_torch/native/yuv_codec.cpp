// YUV 4:2:0 host-side encoder of the yuv420 wire (ai4e_tpu_torch/ops/yuv.py);
// a copy of the JAX package's native/yuv_codec.cpp. It walks the image once
// per 2x2 block with scalar float math the compiler auto-vectorizes, where
// the numpy version's channel-interleaved reductions do not vectorize.
// Contract matches the Python reference (JPEG/JFIF full-range BT.601,
// chroma 2x2 box mean), within 1 LSB where exact halves round:
//   Y  = 0.299 R + 0.587 G + 0.114 B            (rounded, full res)
//   Cb = 128 - 0.168736 R - 0.331264 G + 0.5 B  (on the 2x2-mean RGB)
//   Cr = 128 + 0.5 R - 0.418688 G - 0.081312 B
// Output layout: [Y (h*w)] [Cb (h/2*w/2)] [Cr (h/2*w/2)], all uint8.

#include <cstdint>
#include <cmath>

extern "C" {

// rgb: h*w*3 interleaved uint8; out: h*w + 2*(h/2)*(w/2) planar uint8.
// h and w must be even (the Python wrapper validates). Returns 0 on ok.
int yuv420_encode(const uint8_t* rgb, int h, int w, uint8_t* out) {
    if (h <= 0 || w <= 0 || (h & 1) || (w & 1)) return 1;
    const int n = h * w;
    const int hw2 = w / 2;
    uint8_t* yp = out;
    uint8_t* cbp = out + n;
    uint8_t* crp = out + n + (h / 2) * hw2;

    for (int by = 0; by < h; by += 2) {
        const uint8_t* row0 = rgb + (size_t)by * w * 3;
        const uint8_t* row1 = row0 + (size_t)w * 3;
        uint8_t* y0 = yp + (size_t)by * w;
        uint8_t* y1 = y0 + w;
        uint8_t* cbrow = cbp + (size_t)(by / 2) * hw2;
        uint8_t* crrow = crp + (size_t)(by / 2) * hw2;
        for (int bx = 0; bx < w; bx += 2) {
            const uint8_t* p00 = row0 + (size_t)bx * 3;
            const uint8_t* p01 = p00 + 3;
            const uint8_t* p10 = row1 + (size_t)bx * 3;
            const uint8_t* p11 = p10 + 3;
            // Full-res luma, rounded (inputs are in [0,255] so Y is too —
            // no clip needed).
            y0[bx] = (uint8_t)(0.299f * p00[0] + 0.587f * p00[1]
                               + 0.114f * p00[2] + 0.5f);
            y0[bx + 1] = (uint8_t)(0.299f * p01[0] + 0.587f * p01[1]
                                   + 0.114f * p01[2] + 0.5f);
            y1[bx] = (uint8_t)(0.299f * p10[0] + 0.587f * p10[1]
                               + 0.114f * p10[2] + 0.5f);
            y1[bx + 1] = (uint8_t)(0.299f * p11[0] + 0.587f * p11[1]
                                   + 0.114f * p11[2] + 0.5f);
            // 2x2 RGB sums for the chroma mean (max 1020 fits int).
            const float r = (float)(p00[0] + p01[0] + p10[0] + p11[0]);
            const float g = (float)(p00[1] + p01[1] + p10[1] + p11[1]);
            const float b = (float)(p00[2] + p01[2] + p10[2] + p11[2]);
            float cb = 128.0f + (-0.168736f * r - 0.331264f * g
                                 + 0.5f * b) * 0.25f;
            float cr = 128.0f + (0.5f * r - 0.418688f * g
                                 - 0.081312f * b) * 0.25f;
            cb = cb < 0.0f ? 0.0f : (cb > 255.0f ? 255.0f : cb);
            cr = cr < 0.0f ? 0.0f : (cr > 255.0f ? 255.0f : cr);
            cbrow[bx / 2] = (uint8_t)nearbyintf(cb);
            crrow[bx / 2] = (uint8_t)nearbyintf(cr);
        }
    }
    return 0;
}

}  // extern "C"
