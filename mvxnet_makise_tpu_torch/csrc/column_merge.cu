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
// What bounds them on this card: memory, and nothing else comes close.  At
// the default config (batch 4, R = 320 float32) the forward reads the
// present tap rows once (483 MB) and writes the dense output once (720 MB)
// with at most 9 adds per output element; K3's backward writes dy (566 MB)
// and reads the cotangent rows that live columns touch (271 MB).  These
// are copies with a few adds, so their speed is set by how many bytes each
// SM keeps in flight (about 18 KB at 3.35 TB/s over 132 SMs) and by how
// many instructions each byte costs.
//
// Design.
// * Vector width.  A thread moves 16 bytes at a time (a float4, or 8
//   bfloat16) when R * sizeof(T) is a multiple of 16 and the tensors are
//   16-byte aligned, else one element (the scalar path); the launcher
//   picks.  Loads take the read-only path (__ldg); stores are streaming
//   (__stcs): this kernel never reads its output back.
// * Forward (K1; K3 is the same kernel with the epilogue compiled out):
//   one block per (tile of ny/4 cells, output row ox, frame).  The block
//   first writes the slot ids of the three contributing cx rows into a
//   shared-memory map of 3 x (tile + 2) entries (-1 = no column), so a cell
//   finds its <= 9 taps without a search.  Threads are (tx, ty): tx owns
//   one vector of lanes, ty a group of cells (cells ty, ty + G, ...).  A
//   thread issues all nine tap loads of its cell before it adds any (an
//   absent tap loads nothing and adds 0.0, which leaves a sum that starts
//   at +0.0 unchanged).  One cell at a time keeps K3 at 32 registers and
//   K1 at 48, so 6 and 4 blocks of 320 threads fit an SM; on an H100 two
//   cells per thread took 84-96 registers and made K1 0.75 ms against
//   0.61.  Each cell sums its taps kh-major, kw-minor from 0.0, then adds
//   the bias and applies the ReLU: the plain version's order, so K1's and
//   K3's float32 outputs equal it bit for bit.
// * K1's row statistics, in a fixed order without atomics: each thread
//   sums its cells in order; the G groups' partials meet in shared memory
//   and are summed in group order into the tile's partial row (scratch,
//   B x nx x tiles x 2R floats); a second small kernel sums each row's
//   tile partials in tile order.  The same inputs give the same bits.
//   (A thread-block cluster per row, summing the tiles through distributed
//   shared memory, cost 0.12 ms more at the default config: a cluster's
//   blocks wait for its slowest.)
// * K1 backward, pass 1: one block per (frame, row ox), threads own lanes
//   and walk oy, computing pre once per cell and that row's dbias partial.
//   Pass 2 sums the B*nx partials of each lane in a fixed order (32 row
//   stripes per lane, then the stripes in order through shared memory).
// * K3 backward (and K1's dy): one block per chunk of GATHER_COLS column
//   slots of a frame.  One thread per column finds the column's cx by
//   binary search in bounds (once per column) and writes the cotangent
//   cell of each of its nine taps to shared memory (-1 = out of grid or
//   dead slot).  Threads (tx, ty) then copy the chunk's 9 x GATHER_COLS
//   rows: tx owns a vector of lanes, ty every G-th row, GATHER_UNROLL loads
//   in flight before their stores; a missing tap is written as zeros.  (On
//   an H100, 8 columns and 8 rows in flight ran best of 4-32 columns and
//   4-16 rows: 0.300 ms against 0.321 with 16 and 4.)
// No atomics anywhere, so every result is deterministic.  The TPU kernels'
// lane padding, chunked DMA and one-hot positioning matmuls have no
// counterpart here.  Accumulation is float32 for float32 and bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_record.cuh"

namespace {

constexpr int MERGE_THREADS = 320;   // threads of a forward block, at most
constexpr int MERGE_TILES = 4;       // blocks (oy tiles) per row
constexpr int STATS_THREADS = 256;   // threads of a row-statistics block
constexpr int GATHER_THREADS = 320;  // threads of a backward-gather block
constexpr int GATHER_COLS = 8;       // column slots per backward block
constexpr int GATHER_UNROLL = 8;     // rows per thread with loads in flight
constexpr int LANE_THREADS_MAX = 1024;

// VEC elements of T moved as one word W: 16 bytes, or one element
template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 4> {
    using W = float4;
    static __device__ __forceinline__ void unpack(W w, float* f) {
        f[0] = w.x;
        f[1] = w.y;
        f[2] = w.z;
        f[3] = w.w;
    }
    static __device__ __forceinline__ W pack(const float* f) {
        return make_float4(f[0], f[1], f[2], f[3]);
    }
};

template <>
struct Pack<float, 1> {
    using W = float;
    static __device__ __forceinline__ void unpack(W w, float* f) { f[0] = w; }
    static __device__ __forceinline__ W pack(const float* f) { return f[0]; }
};

// a bfloat16 is the top half of a float32: widening is a shift, narrowing
// rounds to nearest even as __float2bfloat16 does
__device__ __forceinline__ float bf16_bits_to_f32(uint32_t h) {
    return __uint_as_float(h << 16);
}
__device__ __forceinline__ uint32_t f32_to_bf16_bits(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
}

template <>
struct Pack<__nv_bfloat16, 8> {
    using W = uint4;
    static __device__ __forceinline__ void unpack(W w, float* f) {
        const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = bf16_bits_to_f32(u[i] & 0xffffu);
            f[2 * i + 1] = bf16_bits_to_f32(u[i] >> 16);
        }
    }
    static __device__ __forceinline__ W pack(const float* f) {
        uint32_t u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            u[i] = f32_to_bf16_bits(f[2 * i])
                   | (f32_to_bf16_bits(f[2 * i + 1]) << 16);
        return make_uint4(u[0], u[1], u[2], u[3]);
    }
};

template <>
struct Pack<__nv_bfloat16, 1> {
    using W = unsigned short;
    static __device__ __forceinline__ void unpack(W w, float* f) {
        f[0] = bf16_bits_to_f32(w);
    }
    static __device__ __forceinline__ W pack(const float* f) {
        return (unsigned short)f32_to_bf16_bits(f[0]);
    }
};

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

__host__ __device__ constexpr size_t align16(size_t n) {
    return (n + 15) / 16 * 16;
}

// Shared memory of the forward: the slot map, then for K1 the groups'
// statistics partials [2][G][R]
__host__ __device__ constexpr size_t cmap_bytes(int tile) {
    return align16(3 * (size_t)(tile + 2) * sizeof(int32_t));
}

template <typename T, bool EPILOGUE, int VEC>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const T* __restrict__ y, const int32_t* __restrict__ col_cy,
             const int32_t* __restrict__ bounds,
             const float* __restrict__ bias, T* __restrict__ out,
             float* __restrict__ partial, int V, int nx, int ny, int R,
             int tile) {
    using P = Pack<T, VEC>;
    using W = typename P::W;
    extern __shared__ __align__(16) unsigned char smem[];
    int32_t* cmap = reinterpret_cast<int32_t*>(smem);
    const int width = tile + 2;
    const int oy0 = blockIdx.x * tile;
    const int ox = blockIdx.y;
    const int b = blockIdx.z;
    const int cells = max(0, min(tile, ny - oy0));
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;

    for (int i = tid; i < 3 * width; i += nthreads) cmap[i] = -1;
    __syncthreads();
    const int32_t* bnd = bounds + (size_t)b * (nx + 1);
    const int32_t* cyb = col_cy + (size_t)b * V;
    for (int kh = 0; kh < 3; ++kh) {
        const int cx = ox - 1 + kh;
        if (cx < 0 || cx >= nx) continue;
        const int e = bnd[cx + 1];
        for (int j = bnd[cx] + tid; j < e; j += nthreads) {
            // tap kw of local cell c reads the column at
            // cy = oy0 + c - 1 + kw, which sits at map column m = c + kw
            const int cy = cyb[j];
            const int m = cy - oy0 + 1;
            if (cy >= 0 && cy < ny && m >= 0 && m < width)
                cmap[kh * width + m] = j;
        }
    }
    __syncthreads();

    const int nvec = R / VEC;
    const int G = blockDim.y;
    const W* yb = reinterpret_cast<const W*>(y) + (size_t)b * V * 9 * nvec;
    W* orow = reinterpret_cast<W*>(out)
              + (((size_t)b * nx + ox) * ny + oy0) * nvec;
    float* part = reinterpret_cast<float*>(smem + cmap_bytes(tile));
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        float bv[VEC], s1[VEC], s2[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            bv[i] = EPILOGUE ? __ldg(bias + v * VEC + i) : 0.f;
            s1[i] = s2[i] = 0.f;
        }
        for (int c = threadIdx.y; c < cells; c += G) {
            W tap[9];
#pragma unroll
            for (int t = 0; t < 9; ++t) {
                const int j = cmap[(t / 3) * width + c + t % 3];
                tap[t] = j >= 0
                    ? __ldg(yb + ((size_t)j * 9 + t) * nvec + v) : W{};
            }
            float acc[VEC], f[VEC];
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
                P::unpack(tap[t], f);
#pragma unroll
                for (int i = 0; i < VEC; ++i) acc[i] += f[i];
            }
            if (EPILOGUE) {
#pragma unroll
                for (int i = 0; i < VEC; ++i) {
                    acc[i] = fmaxf(acc[i] + bv[i], 0.f);
                    s1[i] += acc[i];
                    s2[i] += acc[i] * acc[i];
                }
            }
            __stcs(orow + (size_t)c * nvec + v, P::pack(acc));
        }
        if (EPILOGUE) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                part[threadIdx.y * R + v * VEC + i] = s1[i];
                part[(G + threadIdx.y) * R + v * VEC + i] = s2[i];
            }
        }
    }

    if constexpr (EPILOGUE) {
        // the tile's sums, each lane's G group partials in group order,
        // into the row's partials [tiles][2][R]
        __syncthreads();
        float* prow = partial
            + (((size_t)b * nx + ox) * gridDim.x + blockIdx.x) * 2 * R;
        for (int i = tid; i < 2 * R; i += nthreads) {
            const int k = i / R, r = i - k * R;
            float s = 0.f;
            for (int g = 0; g < G; ++g) s += part[(k * G + g) * R + r];
            prow[i] = s;
        }
    }
}

// K1 forward, pass 2: each row's statistics, its tiles' partials summed in
// tile order.  One thread per (row, statistic, lane).
__global__ void __launch_bounds__(STATS_THREADS)
merge_stats_kernel(const float* __restrict__ partial,
                   float* __restrict__ stats, int rows, int tiles,
                   int width) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)rows * width) return;
    const size_t row = i / width;
    const float* p = partial + row * tiles * width + (i - row * width);
    float s = 0.f;
    for (int k = 0; k < tiles; ++k) s += p[(size_t)k * width];
    stats[i] = s;
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

// K3 backward: the windowed gather, one block per (chunk of GATHER_COLS
// column slots, frame)
template <typename T, int VEC>
__global__ void __launch_bounds__(GATHER_THREADS)
merge_taps_bwd_kernel(const T* __restrict__ g,
                      const int32_t* __restrict__ col_cy,
                      const int32_t* __restrict__ bounds,
                      T* __restrict__ dy, int V, int nx, int ny, int R) {
    using W = typename Pack<T, VEC>::W;
    // the cotangent cell each (column, tap) row copies; -1 = zeros
    __shared__ int32_t src[GATHER_COLS * 9];
    const int j0 = blockIdx.x * GATHER_COLS;
    const int b = blockIdx.y;
    const int ncols = min(GATHER_COLS, V - j0);
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    const int32_t* bnd = bounds + (size_t)b * (nx + 1);
    for (int i = tid; i < ncols; i += nthreads) {
        const int j = j0 + i;
        const bool live = j < bnd[nx];
        int cx = -1;
        if (live) {
            // cx = (number of k in [0, nx] with bounds[k] <= j) - 1
            int lo = 0, hi = nx + 1;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (bnd[mid] <= j) lo = mid + 1; else hi = mid;
            }
            cx = lo - 1;
        }
        const int cy = col_cy[(size_t)b * V + j];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            const int ox = cx + 1 - t / 3;
            const int oy = cy + 1 - t % 3;
            const bool ok = live && ox >= 0 && ox < nx && oy >= 0 && oy < ny;
            src[i * 9 + t] = ok ? ox * ny + oy : -1;
        }
    }
    __syncthreads();

    const int nvec = R / VEC;
    const int G = blockDim.y;
    const int rows = ncols * 9;
    const W* gb = reinterpret_cast<const W*>(g) + (size_t)b * nx * ny * nvec;
    W* dst = reinterpret_cast<W*>(dy) + ((size_t)b * V + j0) * 9 * nvec;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        for (int q0 = threadIdx.y; q0 < rows; q0 += G * GATHER_UNROLL) {
            W w[GATHER_UNROLL];
#pragma unroll
            for (int k = 0; k < GATHER_UNROLL; ++k) {
                const int q = q0 + k * G;
                const int cell = q < rows ? src[q] : -1;
                w[k] = cell >= 0 ? __ldg(gb + (size_t)cell * nvec + v) : W{};
            }
#pragma unroll
            for (int k = 0; k < GATHER_UNROLL; ++k) {
                const int q = q0 + k * G;
                if (q < rows) __stcs(dst + (size_t)q * nvec + v, w[k]);
            }
        }
    }
}

int lane_threads(int R) {
    int threads = ((R + 31) / 32) * 32;
    return threads > LANE_THREADS_MAX ? LANE_THREADS_MAX : threads;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// elements per word: 16 bytes when every row and tensor allows it
int vector_width(int R, int esize, const void* a, const void* b) {
    return (R * esize) % 16 == 0 && aligned16(a) && aligned16(b)
        ? 16 / esize : 1;
}

// Launch shape of the forward: grid (tiles, nx, B), block (tx, ty)
struct MergeShape {
    dim3 grid, block;
    int tile;
    size_t smem;
};

MergeShape merge_shape(bool fused, int vec, int B, int nx, int ny, int R) {
    const int tiles = ny < MERGE_TILES ? ny : MERGE_TILES;
    const int tile = (ny + tiles - 1) / tiles;
    const int nvec = R / vec;
    const int tx = nvec < MERGE_THREADS ? nvec : MERGE_THREADS;
    int ty = MERGE_THREADS / tx;
    if (ty > tile) ty = tile;
    size_t smem = cmap_bytes(tile);
    if (fused) smem += 2 * (size_t)ty * R * sizeof(float);
    return {dim3(tiles, nx, B), dim3(tx, ty), tile, smem};
}

template <typename T, bool EPILOGUE, int VEC>
int launch_merge_vec(const void* y, const void* col_cy, const void* bounds,
                     const void* bias, void* out, void* stats, void* partial,
                     int B, int V, int nx, int ny, int R,
                     cudaStream_t stream) {
    const auto kernel = merge_kernel<T, EPILOGUE, VEC>;
    const MergeShape s = merge_shape(EPILOGUE, VEC, B, nx, ny, R);
    if (s.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)s.smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<s.grid, s.block, s.smem, stream>>>(
        (const T*)y, (const int32_t*)col_cy, (const int32_t*)bounds,
        (const float*)bias, (T*)out, (float*)partial, V, nx, ny, R, s.tile);
    int err = (int)cudaGetLastError();
    record_launch(kernel, s.grid, s.block, s.smem);
    if (!EPILOGUE || err != 0) return err;
    const int rows = B * nx, width = 2 * R;
    const dim3 grid((unsigned)(((size_t)rows * width + STATS_THREADS - 1)
                               / STATS_THREADS));
    merge_stats_kernel<<<grid, STATS_THREADS, 0, stream>>>(
        (const float*)partial, (float*)stats, rows, (int)s.grid.x, width);
    err = (int)cudaGetLastError();
    record_launch(merge_stats_kernel, grid, dim3(STATS_THREADS), 0);
    return err;
}

template <typename T, bool EPILOGUE>
int launch_merge(const void* y, const void* col_cy, const void* bounds,
                 const void* bias, void* out, void* stats, void* partial,
                 int B, int V, int nx, int ny, int R, void* stream) {
    clear_launches();
    constexpr int WIDE = 16 / sizeof(T);
    const int vec = vector_width(R, sizeof(T), y, out);
    return vec == WIDE
        ? launch_merge_vec<T, EPILOGUE, WIDE>(y, col_cy, bounds, bias, out,
                                              stats, partial, B, V, nx, ny,
                                              R, (cudaStream_t)stream)
        : launch_merge_vec<T, EPILOGUE, 1>(y, col_cy, bounds, bias, out,
                                           stats, partial, B, V, nx, ny, R,
                                           (cudaStream_t)stream);
}

template <typename T>
int launch_fused_bwd(const void* out, const void* g_out, const void* g_stats,
                     void* pre, void* partial, void* dbias, int B, int nx,
                     int ny, int R, void* stream) {
    clear_launches();
    const dim3 pre_grid(nx, B), pre_block(lane_threads(R));
    merge_fused_pre_kernel<T><<<pre_grid, pre_block, 0,
                                (cudaStream_t)stream>>>(
        (const T*)out, (const T*)g_out, (const float*)g_stats, (T*)pre,
        (float*)partial, nx, ny, R);
    int err = (int)cudaGetLastError();
    record_launch(merge_fused_pre_kernel<T>, pre_grid, pre_block, 0);
    if (err != 0) return err;
    const dim3 sum_grid((R + 31) / 32), sum_block(32, 32);
    merge_fused_dbias_kernel<<<sum_grid, sum_block, 0,
                               (cudaStream_t)stream>>>(
        (const float*)partial, (float*)dbias, B * nx, R);
    err = (int)cudaGetLastError();
    record_launch(merge_fused_dbias_kernel, sum_grid, sum_block, 0);
    return err;
}

template <typename T, int VEC>
int launch_taps_bwd_vec(const void* g, const void* col_cy, const void* bounds,
                        void* dy, int B, int V, int nx, int ny, int R,
                        cudaStream_t stream) {
    const int nvec = R / VEC;
    const int tx = nvec < GATHER_THREADS ? nvec : GATHER_THREADS;
    int ty = GATHER_THREADS / tx;
    if (ty > GATHER_COLS * 9) ty = GATHER_COLS * 9;
    const dim3 grid((V + GATHER_COLS - 1) / GATHER_COLS, B), block(tx, ty);
    merge_taps_bwd_kernel<T, VEC><<<grid, block, 0, stream>>>(
        (const T*)g, (const int32_t*)col_cy, (const int32_t*)bounds, (T*)dy,
        V, nx, ny, R);
    const int err = (int)cudaGetLastError();
    record_launch(merge_taps_bwd_kernel<T, VEC>, grid, block, 0);
    return err;
}

template <typename T>
int launch_taps_bwd(const void* g, const void* col_cy, const void* bounds,
                    void* dy, int B, int V, int nx, int ny, int R,
                    void* stream) {
    clear_launches();
    constexpr int WIDE = 16 / sizeof(T);
    const int vec = vector_width(R, sizeof(T), g, dy);
    return vec == WIDE
        ? launch_taps_bwd_vec<T, WIDE>(g, col_cy, bounds, dy, B, V, nx, ny,
                                       R, (cudaStream_t)stream)
        : launch_taps_bwd_vec<T, 1>(g, col_cy, bounds, dy, B, V, nx, ny, R,
                                    (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// partial: scratch of B x nx x tiles x 2R floats, tiles from
// merge_launch_facts
int merge_fused_f32(const void* y, const void* col_cy, const void* bounds,
                    const void* bias, void* out, void* stats, void* partial,
                    int B, int V, int nx, int ny, int R, void* stream) {
    return launch_merge<float, true>(y, col_cy, bounds, bias, out, stats,
                                     partial, B, V, nx, ny, R, stream);
}

int merge_fused_bf16(const void* y, const void* col_cy, const void* bounds,
                     const void* bias, void* out, void* stats, void* partial,
                     int B, int V, int nx, int ny, int R, void* stream) {
    return launch_merge<__nv_bfloat16, true>(y, col_cy, bounds, bias, out,
                                             stats, partial, B, V, nx, ny,
                                             R, stream);
}

int merge_taps_f32(const void* y, const void* col_cy, const void* bounds,
                   void* out, int B, int V, int nx, int ny, int R,
                   void* stream) {
    return launch_merge<float, false>(y, col_cy, bounds, nullptr, out,
                                      nullptr, nullptr, B, V, nx, ny, R,
                                      stream);
}

int merge_taps_bf16(const void* y, const void* col_cy, const void* bounds,
                    void* out, int B, int V, int nx, int ny, int R,
                    void* stream) {
    return launch_merge<__nv_bfloat16, false>(y, col_cy, bounds, nullptr,
                                              out, nullptr, nullptr, B, V,
                                              nx, ny, R, stream);
}

// What a forward launch needs, for the wrapper to check and allocate:
// facts[0] = dynamic shared bytes per block, facts[1] = oy tiles per row
// (K1's partial rows per output row)
int merge_launch_facts(int fused, int element_size, int ny, int R,
                       int* facts) {
    // the vector path's shape: it takes at least the scalar path's memory
    const int vec = (R * element_size) % 16 == 0 ? 16 / element_size : 1;
    const MergeShape s = merge_shape(fused != 0, vec, 1, 1, ny, R);
    facts[0] = (int)s.smem;
    facts[1] = (int)s.grid.x;
    return 0;
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
