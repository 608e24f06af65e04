// K1 and K3: the column merge for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernels of mvxnet_makise_tpu/ops/pallas_column_merge.py:
//   K1  merge_taps_fused (Pallas body _merge_fused_kernel, launched by
//       _merge_fused_fwd_pallas) and its custom VJP _merge_fused_bwd;
//   K3  merge_taps (Pallas body _merge_kernel, launched by
//       _merge_fwd_pallas) and its custom VJP _merge_taps_bwd.
// Their plain PyTorch versions are merge_taps_fused_plain and
// merge_taps_plain in ops/column_merge.py; the backward plain versions are
// autograd through those.
//
// What they compute.  CML conv1 runs as one matmul over the active BEV
// columns, which leaves per column j (sorted by (cx, cy)) nine tap rows
// y[b, j, t, :] (t = 3*kh + kw).  For every frame b, output row ox, cell oy
// and lane r (r = d*Cout + c):
//   merged[b,ox,oy,r] = sum_{kh,kw} y[b, col(ox-1+kh, oy-1+kw), 3kh+kw, r]
// where col(cx, cy) is the active column at that BEV cell; out-of-grid taps
// and absent columns contribute nothing.  The columns of BEV row cx are the
// slots [bounds[b,cx], bounds[b,cx+1]) and col_cy gives each slot's cy.
// K3 returns merged.  K1 adds the epilogue:
//   out[b,ox,oy,r]  = relu(bias[r] + merged[b,ox,oy,r])
//   stats[b,ox,0,r] = sum_oy out[b,ox,oy,r],  stats[b,ox,1,r] = sum_oy out^2
// K1's backward, given g_out and g_stats:
//   pre[b,ox,oy,r] = (g_out + g_stats[b,ox,0,r] + 2 out g_stats[b,ox,1,r])
//                    * [out > 0]
//   dbias[r]       = sum over every cell of pre (the bias lands on
//                    inactive cells too)
//   dy             = K3's backward of pre.
// K3's backward is a windowed gather: dy[b,j,3kh+kw,r] = g[b, cx+1-kh,
// cy+1-kw, r] for the column's (cx, cy), 0 out of grid or for a dead slot.
//
// What bounds them on this card: memory.  Forward: each present tap row is
// read once and each output element written once; the dense (nx, ny, R)
// output dominates (about 180 MB per frame at the default config in
// float32) against at most 9 adds per output element.  Backward: out and
// g_out are read once (180 MB each per frame) and dy written once.
//
// Design.
// * Forward: one block per (frame, output row ox).  The block first writes
//   the slot ids of the three contributing cx rows into a shared-memory map
//   of 3 x (ny + 2) entries (-1 = no column, one cell of padding each side),
//   so every output cell finds its <= 9 taps without a search.  Threads
//   then own lanes r and walk oy: each cell gathers its taps (loads
//   coalesced over r), and for K1 adds the bias, applies ReLU and keeps sum
//   and sum of squares in registers; each output is written once.  K3 is
//   the same kernel with the epilogue compiled out (template flag).
// * K1 backward, pass 1: one block per (frame, row ox), threads own lanes
//   and walk oy, computing pre once per cell and that row's dbias partial.
//   Pass 2 sums the B*nx partials of each lane in a fixed order (32 row
//   stripes per lane, then the stripes in order through shared memory).
// * K3 backward (and K1's dy): one block per (frame, column slot), threads
//   own lanes; the block finds the column's cx by binary search in bounds
//   and copies its nine window cells.
// No atomics anywhere, so every result is deterministic.  The TPU kernels'
// lane padding, chunked DMA and one-hot positioning matmuls have no
// counterpart here.  Accumulation is float32 for float32 and bfloat16.

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
// v rounded to T, as a float
__device__ __forceinline__ float rounded(float v, const float*) { return v; }
__device__ __forceinline__ float rounded(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16(v));
}

template <typename T, bool EPILOGUE>
__global__ void merge_kernel(const T* __restrict__ y,
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
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
        const float bias_r = EPILOGUE ? bias[r] : 0.f;
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
            if (EPILOGUE) {
                const float v = fmaxf(acc + bias_r, 0.f);
                store(orow + (size_t)oy * R + r, v);
                s1 += v;
                s2 += v * v;
            } else {
                store(orow + (size_t)oy * R + r, acc);
            }
        }
        if (EPILOGUE) {
            float* srow = stats + ((size_t)b * nx + ox) * 2 * (size_t)R;
            srow[r] = s1;
            srow[R + r] = s2;
        }
    }
}

// K1 backward, pass 1: pre and one dbias partial per (frame, row, lane)
template <typename T>
__global__ void merge_fused_pre_kernel(const T* __restrict__ out,
                                       const T* __restrict__ g_out,
                                       const float* __restrict__ g_stats,
                                       T* __restrict__ pre,
                                       float* __restrict__ partial,
                                       int nx, int ny, int R) {
    const size_t row = (size_t)blockIdx.y * nx + blockIdx.x;
    const T* orow = out + row * ny * R;
    const T* grow = g_out + row * ny * R;
    T* prow = pre + row * ny * R;
    const float* gs = g_stats + row * 2 * R;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
        // the stats cotangents enter in T, as the JAX VJP casts them
        const float g_sum = rounded(gs[r], out);
        const float g_sq = rounded(gs[R + r], out);
        float acc = 0.f;
        for (int oy = 0; oy < ny; ++oy) {
            const size_t i = (size_t)oy * R + r;
            const float o = to_f32(orow[i]);
            const float h = to_f32(grow[i]) + g_sum + 2.f * o * g_sq;
            const float p = rounded(o > 0.f ? h : 0.f, out);
            store(prow + i, p);
            acc += p;
        }
        partial[row * R + r] = acc;
    }
}

// K1 backward, pass 2: dbias[r] = sum of the n_rows partials of lane r, in
// a fixed order.  Block (32 lanes, 32 stripes).
__global__ void merge_fused_dbias_kernel(const float* __restrict__ partial,
                                         float* __restrict__ dbias,
                                         int n_rows, int R) {
    __shared__ float part[32][33];
    const int r = blockIdx.x * 32 + threadIdx.x;
    float acc = 0.f;
    if (r < R)
        for (int n = threadIdx.y; n < n_rows; n += 32)
            acc += partial[(size_t)n * R + r];
    part[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && r < R) {
        float s = 0.f;
        for (int k = 0; k < 32; ++k) s += part[k][threadIdx.x];
        dbias[r] = s;
    }
}

// K3 backward: the windowed gather, one block per (column slot, frame)
template <typename T>
__global__ void merge_taps_bwd_kernel(const T* __restrict__ g,
                                      const int32_t* __restrict__ col_cy,
                                      const int32_t* __restrict__ bounds,
                                      T* __restrict__ dy,
                                      int V, int nx, int ny, int R) {
    const int j = blockIdx.x;
    const int b = blockIdx.y;
    const int32_t* bnd = bounds + (size_t)b * (nx + 1);
    T* dst = dy + ((size_t)b * V + j) * 9 * R;
    const bool live = j < bnd[nx];
    int cx = -1;
    if (live) {
        // cx = (number of i in [0, nx] with bounds[i] <= j) - 1
        int lo = 0, hi = nx + 1;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (bnd[mid] <= j) lo = mid + 1; else hi = mid;
        }
        cx = lo - 1;
    }
    const int cy = col_cy[(size_t)b * V + j];
    const T* gb = g + (size_t)b * nx * ny * R;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
        const int ox = cx + 1 - t / 3;
        const int oy = cy + 1 - t % 3;
        const bool ok = live && ox >= 0 && ox < nx && oy >= 0 && oy < ny;
        const T* src = gb + ((size_t)ox * ny + oy) * R;
        for (int r = threadIdx.x; r < R; r += blockDim.x)
            store(dst + (size_t)t * R + r, ok ? to_f32(src[r]) : 0.f);
    }
}

int lane_threads(int R) {
    int threads = ((R + 31) / 32) * 32;
    return threads > 1024 ? 1024 : threads;
}

template <typename T, bool EPILOGUE>
int launch_merge(const void* y, const void* col_cy, const void* bounds,
                 const void* bias, void* out, void* stats, int B, int V,
                 int nx, int ny, int R, void* stream) {
    const size_t smem = 3 * (size_t)(ny + 2) * sizeof(int32_t);
    merge_kernel<T, EPILOGUE><<<dim3(nx, B), lane_threads(R), smem,
                                (cudaStream_t)stream>>>(
        (const T*)y, (const int32_t*)col_cy, (const int32_t*)bounds,
        (const float*)bias, (T*)out, (float*)stats, V, nx, ny, R);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_fused_bwd(const void* out, const void* g_out, const void* g_stats,
                     void* pre, void* partial, void* dbias, int B, int nx,
                     int ny, int R, void* stream) {
    merge_fused_pre_kernel<T><<<dim3(nx, B), lane_threads(R), 0,
                                (cudaStream_t)stream>>>(
        (const T*)out, (const T*)g_out, (const float*)g_stats, (T*)pre,
        (float*)partial, nx, ny, R);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    merge_fused_dbias_kernel<<<(R + 31) / 32, dim3(32, 32), 0,
                               (cudaStream_t)stream>>>(
        (const float*)partial, (float*)dbias, B * nx, R);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_taps_bwd(const void* g, const void* col_cy, const void* bounds,
                    void* dy, int B, int V, int nx, int ny, int R,
                    void* stream) {
    merge_taps_bwd_kernel<T><<<dim3(V, B), lane_threads(R), 0,
                               (cudaStream_t)stream>>>(
        (const T*)g, (const int32_t*)col_cy, (const int32_t*)bounds, (T*)dy,
        V, nx, ny, R);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int merge_fused_f32(const void* y, const void* col_cy, const void* bounds,
                    const void* bias, void* out, void* stats, int B, int V,
                    int nx, int ny, int R, void* stream) {
    return launch_merge<float, true>(y, col_cy, bounds, bias, out, stats, B,
                                     V, nx, ny, R, stream);
}

int merge_fused_bf16(const void* y, const void* col_cy, const void* bounds,
                     const void* bias, void* out, void* stats, int B, int V,
                     int nx, int ny, int R, void* stream) {
    return launch_merge<__nv_bfloat16, true>(y, col_cy, bounds, bias, out,
                                             stats, B, V, nx, ny, R, stream);
}

int merge_taps_f32(const void* y, const void* col_cy, const void* bounds,
                   void* out, int B, int V, int nx, int ny, int R,
                   void* stream) {
    return launch_merge<float, false>(y, col_cy, bounds, nullptr, out,
                                      nullptr, B, V, nx, ny, R, stream);
}

int merge_taps_bf16(const void* y, const void* col_cy, const void* bounds,
                    void* out, int B, int V, int nx, int ny, int R,
                    void* stream) {
    return launch_merge<__nv_bfloat16, false>(y, col_cy, bounds, nullptr,
                                              out, nullptr, B, V, nx, ny, R,
                                              stream);
}

int merge_fused_bwd_f32(const void* out, const void* g_out,
                        const void* g_stats, void* pre, void* partial,
                        void* dbias, int B, int nx, int ny, int R,
                        void* stream) {
    return launch_fused_bwd<float>(out, g_out, g_stats, pre, partial, dbias,
                                   B, nx, ny, R, stream);
}

int merge_fused_bwd_bf16(const void* out, const void* g_out,
                         const void* g_stats, void* pre, void* partial,
                         void* dbias, int B, int nx, int ny, int R,
                         void* stream) {
    return launch_fused_bwd<__nv_bfloat16>(out, g_out, g_stats, pre, partial,
                                           dbias, B, nx, ny, R, stream);
}

int merge_taps_bwd_f32(const void* g, const void* col_cy, const void* bounds,
                       void* dy, int B, int V, int nx, int ny, int R,
                       void* stream) {
    return launch_taps_bwd<float>(g, col_cy, bounds, dy, B, V, nx, ny, R,
                                  stream);
}

int merge_taps_bwd_bf16(const void* g, const void* col_cy,
                        const void* bounds, void* dy, int B, int V, int nx,
                        int ny, int R, void* stream) {
    return launch_taps_bwd<__nv_bfloat16>(g, col_cy, bounds, dy, B, V, nx,
                                          ny, R, stream);
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
