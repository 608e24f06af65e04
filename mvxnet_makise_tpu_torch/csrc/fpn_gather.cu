// K2: FPN bilinear gather for Hopper (sm_90a).
//
// Replaces the TPU kernel fpn_gather_banded in
// mvxnet_makise_tpu/ops/pallas_gather.py (Pallas body _gather_kernel),
// which computes the function of ops/gather.py's bilinear_gather_fpn_batch.
// Its plain PyTorch version is fpn_gather_plain in ops/gather.py.
//
// What it computes.  For point p of frame b at original-image pixel
// (row, col) and each FPN level l of shape (Hf, Wf, C):
//   r  = clamp(row / ry_l - eps, 0, Hf - 1),  ry_l = h / Hf   (c likewise)
//   r0 = floor(r), r1 = min(r0 + 1, Hf - 1), fr = r - r0       (c likewise)
//   out[b, p, off_l + ch] = f(r0,c0) (1-fr)(1-fc) + f(r1,c0) fr (1-fc)
//                         + f(r0,c1) (1-fr) fc    + f(r1,c1) fr fc
// (the reference's swapped weights exchange fr <-> 1-fr and fc <-> 1-fc),
// levels concatenated along channels, and 0 for invalid points.  The
// output is in point order: the TPU kernel's band-sorted padded order is a
// layout for its matrix unit and has no counterpart here.
//
// What bounds it on this card: memory.  Every output value is written once
// (P x 768 floats per frame) and the feature cells the points touch are
// read; the arithmetic is about 8 flops per output value.
//
// Design.  One warp per point.  The tap cells and weights of each level are
// computed once per point (each lane repeats the few scalar operations),
// then the lanes cover the channels with 16-byte (float4) loads and stores,
// so every tap row and the output row move as contiguous, coalesced
// segments.  No shared memory and no atomics.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

struct Level {
    const float* f;   // (B, H, W, C) channels-last
    int H, W, C;
    float ry, rx;     // original-image pixels per feature cell
};

struct Levels {
    Level l[3];
};

__global__ void fpn_gather_kernel(Levels L, const float* __restrict__ rc,
                                  const uint8_t* __restrict__ valid,
                                  float* __restrict__ out, int B, int P,
                                  int Ctot, float eps, int swapped) {
    const long long warp =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= (long long)B * P) return;
    const int b = (int)(warp / P);
    float4* o = reinterpret_cast<float4*>(out + warp * Ctot);

    if (!valid[warp]) {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c4 = lane; c4 < Ctot / 4; c4 += 32) o[c4] = zero;
        return;
    }
    const float row = rc[2 * warp];
    const float col = rc[2 * warp + 1];

    int off4 = 0;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
        const Level lv = L.l[l];
        const float r = fminf(fmaxf(row / lv.ry - eps, 0.f), (float)(lv.H - 1));
        const float c = fminf(fmaxf(col / lv.rx - eps, 0.f), (float)(lv.W - 1));
        const int r0 = (int)floorf(r);
        const int c0 = (int)floorf(c);
        const int r1 = min(r0 + 1, lv.H - 1);
        const int c1 = min(c0 + 1, lv.W - 1);
        const float fr = r - (float)r0;
        const float fc = c - (float)c0;
        float w00, w10, w01, w11;
        if (swapped) {
            w00 = fr * fc;
            w10 = (1.f - fr) * fc;
            w01 = fr * (1.f - fc);
            w11 = (1.f - fr) * (1.f - fc);
        } else {
            w00 = (1.f - fr) * (1.f - fc);
            w10 = fr * (1.f - fc);
            w01 = (1.f - fr) * fc;
            w11 = fr * fc;
        }
        const size_t img = (size_t)b * lv.H;
        const float4* t00 = reinterpret_cast<const float4*>(
            lv.f + ((img + r0) * lv.W + c0) * lv.C);
        const float4* t10 = reinterpret_cast<const float4*>(
            lv.f + ((img + r1) * lv.W + c0) * lv.C);
        const float4* t01 = reinterpret_cast<const float4*>(
            lv.f + ((img + r0) * lv.W + c1) * lv.C);
        const float4* t11 = reinterpret_cast<const float4*>(
            lv.f + ((img + r1) * lv.W + c1) * lv.C);
        const int C4 = lv.C / 4;
        for (int c4 = lane; c4 < C4; c4 += 32) {
            const float4 a = __ldg(t00 + c4), bb = __ldg(t10 + c4);
            const float4 cc = __ldg(t01 + c4), d = __ldg(t11 + c4);
            float4 v;
            v.x = a.x * w00 + bb.x * w10 + cc.x * w01 + d.x * w11;
            v.y = a.y * w00 + bb.y * w10 + cc.y * w01 + d.y * w11;
            v.z = a.z * w00 + bb.z * w10 + cc.z * w01 + d.z * w11;
            v.w = a.w * w00 + bb.w * w10 + cc.w * w01 + d.w * w11;
            o[off4 + c4] = v;
        }
        off4 += C4;
    }
}

}  // namespace

extern "C" {

int fpn_gather_f32(const void* f0, int H0, int W0, int C0, float ry0,
                   float rx0, const void* f1, int H1, int W1, int C1,
                   float ry1, float rx1, const void* f2, int H2, int W2,
                   int C2, float ry2, float rx2, const void* rc,
                   const void* valid, void* out, int B, int P, float eps,
                   int swapped, void* stream) {
    Levels L;
    L.l[0] = Level{(const float*)f0, H0, W0, C0, ry0, rx0};
    L.l[1] = Level{(const float*)f1, H1, W1, C1, ry1, rx1};
    L.l[2] = Level{(const float*)f2, H2, W2, C2, ry2, rx2};
    const int threads = 256;                      // 8 points per block
    const long long warps = (long long)B * P;
    const long long blocks = (warps * 32 + threads - 1) / threads;
    fpn_gather_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        L, (const float*)rc, (const uint8_t*)valid, (float*)out, B, P,
        C0 + C1 + C2, eps, swapped);
    return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
