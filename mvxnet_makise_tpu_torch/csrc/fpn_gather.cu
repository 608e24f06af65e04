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
// In bfloat16 (fpn_gather_bf16: bfloat16 levels and output, float32
// points) the kernel follows JAX's bfloat16 gather: the fractional offsets
// fr and fc are rounded to bfloat16 (the feature dtype), the taps are
// weighted and summed in float32, as the TPU kernel's matrix unit
// accumulates, and the sum is rounded once.
//
// What bounds it on this card: memory.  Every output value is written once
// (P x 768 values per frame) and the feature cells the points touch are
// read; the arithmetic is about 8 flops per output value.
//
// Design.  One warp per point.  The tap cells and weights of each level are
// computed once per point (each lane repeats the few scalar operations),
// then the lanes cover the channels with 16-byte loads and stores (4
// float32 or 8 bfloat16 values), so every tap row and the output row move
// as contiguous, coalesced segments.  No shared memory and no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_record.cuh"

namespace {

// element types: storage, values per 16-byte vector, conversions
struct F32 {
    using raw = float;
    static constexpr int N = 4;
    __device__ static float load(float x) { return x; }
    __device__ static float store(float x) { return x; }
    __device__ static float weight(float x) { return x; }
};

struct BF16 {
    using raw = unsigned short;
    static constexpr int N = 8;
    __device__ static float load(unsigned short x) {
        return __bfloat162float(__ushort_as_bfloat16(x));
    }
    __device__ static unsigned short store(float x) {
        return __bfloat16_as_ushort(__float2bfloat16(x));
    }
    // the offsets in the feature dtype, as JAX casts them
    __device__ static float weight(float x) {
        return __bfloat162float(__float2bfloat16(x));
    }
};

template <class D>
union Pack {
    uint4 u;
    typename D::raw v[D::N];
};

template <class D>
struct Level {
    const typename D::raw* f;   // (B, H, W, C) channels-last
    int H, W, C;
    float ry, rx;               // original-image pixels per feature cell
};

template <class D>
struct Levels {
    Level<D> l[3];
};

template <class D>
__global__ void fpn_gather_kernel(Levels<D> L, const float* __restrict__ rc,
                                  const uint8_t* __restrict__ valid,
                                  typename D::raw* __restrict__ out, int B,
                                  int P, int Ctot, float eps, int swapped) {
    constexpr int N = D::N;
    const long long warp =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= (long long)B * P) return;
    const int b = (int)(warp / P);
    uint4* o = reinterpret_cast<uint4*>(out + warp * Ctot);

    if (!valid[warp]) {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (int cn = lane; cn < Ctot / N; cn += 32) o[cn] = zero;
        return;
    }
    const float row = rc[2 * warp];
    const float col = rc[2 * warp + 1];

    int offn = 0;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
        const Level<D> lv = L.l[l];
        const float r = fminf(fmaxf(row / lv.ry - eps, 0.f), (float)(lv.H - 1));
        const float c = fminf(fmaxf(col / lv.rx - eps, 0.f), (float)(lv.W - 1));
        const int r0 = (int)floorf(r);
        const int c0 = (int)floorf(c);
        const int r1 = min(r0 + 1, lv.H - 1);
        const int c1 = min(c0 + 1, lv.W - 1);
        const float fr = D::weight(r - (float)r0);
        const float fc = D::weight(c - (float)c0);
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
        const uint4* t00 = reinterpret_cast<const uint4*>(
            lv.f + ((img + r0) * lv.W + c0) * lv.C);
        const uint4* t10 = reinterpret_cast<const uint4*>(
            lv.f + ((img + r1) * lv.W + c0) * lv.C);
        const uint4* t01 = reinterpret_cast<const uint4*>(
            lv.f + ((img + r0) * lv.W + c1) * lv.C);
        const uint4* t11 = reinterpret_cast<const uint4*>(
            lv.f + ((img + r1) * lv.W + c1) * lv.C);
        const int CN = lv.C / N;
        for (int cn = lane; cn < CN; cn += 32) {
            Pack<D> a, bb, cc, d, v;
            a.u = __ldg(t00 + cn);
            bb.u = __ldg(t10 + cn);
            cc.u = __ldg(t01 + cn);
            d.u = __ldg(t11 + cn);
#pragma unroll
            for (int j = 0; j < N; ++j)
                v.v[j] = D::store(D::load(a.v[j]) * w00 + D::load(bb.v[j]) * w10
                                  + D::load(cc.v[j]) * w01
                                  + D::load(d.v[j]) * w11);
            o[offn + cn] = v.u;
        }
        offn += CN;
    }
}

template <class D>
int launch(const void* f0, int H0, int W0, int C0, float ry0, float rx0,
           const void* f1, int H1, int W1, int C1, float ry1, float rx1,
           const void* f2, int H2, int W2, int C2, float ry2, float rx2,
           const void* rc, const void* valid, void* out, int B, int P,
           float eps, int swapped, void* stream) {
    using raw = typename D::raw;
    Levels<D> L;
    L.l[0] = Level<D>{(const raw*)f0, H0, W0, C0, ry0, rx0};
    L.l[1] = Level<D>{(const raw*)f1, H1, W1, C1, ry1, rx1};
    L.l[2] = Level<D>{(const raw*)f2, H2, W2, C2, ry2, rx2};
    const int threads = 256;                      // 8 points per block
    const long long warps = (long long)B * P;
    const long long blocks = (warps * 32 + threads - 1) / threads;
    clear_launches();
    fpn_gather_kernel<D><<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        L, (const float*)rc, (const uint8_t*)valid, (raw*)out, B, P,
        C0 + C1 + C2, eps, swapped);
    const int err = (int)cudaGetLastError();
    record_launch(fpn_gather_kernel<D>, dim3((unsigned)blocks), dim3(threads),
                  0);
    return err;
}

}  // namespace

extern "C" {

#define FPN_GATHER_ARGS                                                      \
    const void *f0, int H0, int W0, int C0, float ry0, float rx0,          \
        const void *f1, int H1, int W1, int C1, float ry1, float rx1,      \
        const void *f2, int H2, int W2, int C2, float ry2, float rx2,      \
        const void *rc, const void *valid, void *out, int B, int P,        \
        float eps, int swapped, void *stream
#define FPN_GATHER_PASS                                                      \
    f0, H0, W0, C0, ry0, rx0, f1, H1, W1, C1, ry1, rx1, f2, H2, W2, C2, ry2, \
        rx2, rc, valid, out, B, P, eps, swapped, stream

int fpn_gather_f32(FPN_GATHER_ARGS) { return launch<F32>(FPN_GATHER_PASS); }

int fpn_gather_bf16(FPN_GATHER_ARGS) { return launch<BF16>(FPN_GATHER_PASS); }

const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
