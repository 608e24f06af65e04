// K1: fused column merge for Hopper (sm_90a).
//
// Replaces the TPU kernel merge_taps_fused in
// mvxnet_makise_tpu/ops/pallas_column_merge.py (Pallas body
// _merge_fused_kernel, launched by _merge_fused_fwd_pallas).  Its plain
// PyTorch version is merge_taps_fused_plain in ops/column_merge.py.
//
// What it computes.  CML conv1 runs as one matmul over the active BEV
// columns, which leaves per column j (sorted by (cx, cy)) nine tap rows
// y[b, j, t, :] (t = 3*kh + kw).  For every frame b, output row ox, cell oy
// and lane r (r = d*Cout + c):
//   out[b,ox,oy,r]    = relu(bias[r] + sum_{kh,kw} y[b, col(ox-1+kh, oy-1+kw), 3kh+kw, r])
//   stats[b,ox,0,r]   = sum_oy out[b,ox,oy,r]
//   stats[b,ox,1,r]   = sum_oy out[b,ox,oy,r]^2
// where col(cx, cy) is the active column at that BEV cell; out-of-grid taps
// and absent columns contribute nothing.  The columns of BEV row cx are the
// slots [bounds[b,cx], bounds[b,cx+1]) and col_cy gives each slot's cy.
//
// What bounds it on this card: memory.  Each present tap row is read once
// and each output element is written once; the dense (nx, ny, R) output
// dominates (about 180 MB per frame at the default config in float32),
// against at most 9 adds per output element.
//
// Design.  One block per (frame, output row ox).  The block first writes the
// slot ids of the three contributing cx rows into a shared-memory map of
// 3 x (ny + 2) entries (-1 = no column, one cell of padding each side), so
// every output cell finds its <= 9 taps without a search.  Threads then own
// lanes r and walk oy: each cell gathers its taps (loads coalesced over r),
// adds the bias, applies ReLU, writes once, and keeps sum and sum of squares
// in registers.  No atomics, so the result is deterministic.  The TPU
// kernel's lane padding, chunked DMA and one-hot positioning matmuls have no
// counterpart here.  Accumulation is float32 for float32 and bfloat16 y.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

template <typename T>
__global__ void merge_fused_kernel(const T* __restrict__ y,
                                   const int32_t* __restrict__ col_cy,
                                   const int32_t* __restrict__ bounds,
                                   const float* __restrict__ bias,
                                   T* __restrict__ out,
                                   float* __restrict__ stats,
                                   int V, int nx, int ny, int R) {
    extern __shared__ int32_t cmap[];  // 3 rows x (ny + 2) slot ids
    const int ox = blockIdx.x;
    const int b = blockIdx.y;
    const int width = ny + 2;

    for (int i = threadIdx.x; i < 3 * width; i += blockDim.x) cmap[i] = -1;
    __syncthreads();
    const int32_t* bnd = bounds + (size_t)b * (nx + 1);
    const int32_t* cyb = col_cy + (size_t)b * V;
    for (int kh = 0; kh < 3; ++kh) {
        const int cx = ox - 1 + kh;
        if (cx < 0 || cx >= nx) continue;
        const int e = bnd[cx + 1];
        for (int j = bnd[cx] + threadIdx.x; j < e; j += blockDim.x) {
            const int cy = cyb[j];
            if (cy >= 0 && cy < ny) cmap[kh * width + cy + 1] = j;
        }
    }
    __syncthreads();

    const T* yb = y + (size_t)b * V * 9 * R;
    T* orow = out + ((size_t)b * nx + ox) * (size_t)ny * R;
    float* srow = stats + ((size_t)b * nx + ox) * 2 * (size_t)R;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
        const float bias_r = bias[r];
        float s1 = 0.f, s2 = 0.f;
        for (int oy = 0; oy < ny; ++oy) {
            float acc = 0.f;
#pragma unroll
            for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
                for (int kw = 0; kw < 3; ++kw) {
                    // cell (ox-1+kh, oy-1+kw) sits at map column oy + kw
                    const int j = cmap[kh * width + oy + kw];
                    if (j >= 0)
                        acc += to_f32(yb[((size_t)j * 9 + kh * 3 + kw) * R + r]);
                }
            }
            const float v = fmaxf(acc + bias_r, 0.f);
            store(orow + (size_t)oy * R + r, v);
            s1 += v;
            s2 += v * v;
        }
        srow[r] = s1;
        srow[R + r] = s2;
    }
}

template <typename T>
int launch(const void* y, const void* col_cy, const void* bounds,
           const void* bias, void* out, void* stats, int B, int V, int nx,
           int ny, int R, void* stream) {
    int threads = ((R + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    const size_t smem = 3 * (size_t)(ny + 2) * sizeof(int32_t);
    merge_fused_kernel<T><<<dim3(nx, B), threads, smem,
                            (cudaStream_t)stream>>>(
        (const T*)y, (const int32_t*)col_cy, (const int32_t*)bounds,
        (const float*)bias, (T*)out, (float*)stats, V, nx, ny, R);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int merge_fused_f32(const void* y, const void* col_cy, const void* bounds,
                    const void* bias, void* out, void* stats, int B, int V,
                    int nx, int ny, int R, void* stream) {
    return launch<float>(y, col_cy, bounds, bias, out, stats, B, V, nx, ny,
                         R, stream);
}

int merge_fused_bf16(const void* y, const void* col_cy, const void* bounds,
                     const void* bias, void* out, void* stats, int B, int V,
                     int nx, int ny, int R, void* stream) {
    return launch<__nv_bfloat16>(y, col_cy, bounds, bias, out, stats, B, V,
                                 nx, ny, R, stream);
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
