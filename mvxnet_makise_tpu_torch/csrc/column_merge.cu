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
//   picks.  Loads take the read-only path (__ldg); the forward's stores
//   are streaming (__stcs): it never reads its output back.
// * Forward (K1; K3 is the same kernel with the epilogue compiled out):
//   one block per (tile of ny/4 cells, output row ox, frame).  The block
//   first writes the slot ids of the three contributing cx rows into a
//   shared-memory map of 3 x (tile + 2) entries (-1 = no column), then
//   turns it into each cell's list of present taps (their rows of y,
//   kh-major, kw-minor) and its count.  Threads are (tx, ty): tx owns one
//   vector of lanes, ty a group of cells (cells ty, ty + G, ...).  A cell
//   loads, widens and adds only its present taps, TAP_BATCH loads in
//   flight before their adds; a cell with no tap stores the word packed
//   once per thread (relu(bias), or 0 for K3).  Skipping is exact: the sum
//   starts at +0.0, is never -0.0, and adding +0.0 leaves it unchanged.
//   Each cell sums its taps kh-major, kw-minor from 0.0, then adds the
//   bias and applies the ReLU: the plain version's order, so K1's and K3's
//   float32 outputs equal it bit for bit, and K1's bfloat16 output equals
//   the float32 sum rounded once.  Timings below are kernel_ab.py's, on an
//   H100 80GB HBM3 at 700 W, on full_fusion.yaml's arguments (bfloat16)
//   and the default Config's (float32).  About 92 % of the (cell, tap)
//   pairs are absent there; the earlier body widened and added all nine
//   taps of every cell (about 250 instructions per 16-byte bfloat16 word,
//   84 registers): 0.400 ms against 0.263 now (bound 0.181), float32 0.546
//   against 0.446.  The launch bound asks MERGE_MIN_BLOCKS blocks per SM,
//   which holds bfloat16 K1 at 64 registers: without it, 94 registers and
//   0.305 ms; 4 blocks (48 registers) spill and take 0.490; TAP_BATCH 8
//   spills (0.494), 2 takes 0.283.  (Earlier, two cells per thread took
//   84-96 registers and made float32 K1 0.75 ms against 0.61.)
// * K1's row statistics, in a fixed order without atomics: each thread
//   sums its cells in order; the G groups' partials meet in shared memory
//   and are summed in group order into the tile's partial row (scratch,
//   B x nx x tiles x 2R floats); a second small kernel sums each row's
//   tile partials in tile order.  The same inputs give the same bits.
//   (A thread-block cluster per row, summing the tiles through distributed
//   shared memory, cost 0.12 ms more at the default config on an H100
//   80GB HBM3 at 700 W: a cluster's blocks wait for its slowest.)
// * K1 backward, pass 1: a streaming pass over out and g_out.  One block
//   per (segment of at most PRE_CELLS cells, row ox, frame), threads (tx,
//   ty) as in the forward: tx a vector of lanes, ty every G-th cell, with
//   PRE_UNROLL cells' loads in flight before their stores.  Each thread
//   sums its cells' pre in cell order, the groups meet in shared memory in
//   group order, and each block writes one dbias partial row (scratch, B x
//   nx x segments x R floats).  Pass 2 sums each lane's partials in a
//   fixed order: DBIAS_STRIPES strided stripes, then the stripes in order
//   through shared memory.  pre's formula is the earlier scalar pass's,
//   one cell at a time, so pre (and dy) keep its bits.  That pass (a block
//   per row, a thread per lane walking 400 cells with 2- or 4-byte
//   accesses) took 0.469 ms in bfloat16 and 0.801 in float32; this one
//   0.375 and 0.746, at 80 and 64 registers, against its own bytes bound of
//   0.326 and 0.649 (kernel_ab.py, H100 80GB HBM3 at 700 W).  Capping it at
//   64 registers spills (0.417); 200 cells and 2 in flight per thread take
//   0.382, 50 cells 0.379.
// * K3 backward (and K1's dy): one block per chunk of GATHER_COLS column
//   slots of a frame.  One thread per column finds the column's cx by
//   binary search in bounds (once per column) and writes the cotangent
//   cell of each of its nine taps to shared memory (-1 = out of grid or
//   dead slot).  Threads (tx, ty) then copy the chunk's 9 x GATHER_COLS
//   rows: tx owns a vector of lanes, ty every G-th row, GATHER_UNROLL loads
//   in flight before their stores; a missing tap is written as zeros.  (On
//   an H100 80GB HBM3 at 700 W, 8 columns and 8 rows in flight ran best of
//   4-32 columns and 4-16 rows: 0.300 ms against 0.321 with 16 and 4.)
// No atomics anywhere, so every result is deterministic.  The TPU kernels'
// lane padding, chunked DMA and one-hot positioning matmuls have no
// counterpart here.  Accumulation is float32 for float32 and bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_record.cuh"

namespace {

constexpr int MERGE_THREADS = 320;   // threads of a forward block, at most
constexpr int MERGE_MIN_BLOCKS = 3;  // forward blocks an SM must hold
constexpr int MERGE_TILES = 4;       // blocks (oy tiles) per row
constexpr int TAP_BATCH = 4;         // tap loads in flight per cell
constexpr int STATS_THREADS = 256;   // threads of a row-statistics block
constexpr int PRE_THREADS = 320;     // threads of a backward pass-1 block
constexpr int PRE_CELLS = 100;       // cells per pass-1 block, at most
constexpr int PRE_UNROLL = 4;        // cells per thread with loads in flight
constexpr int DBIAS_LANES = 8;       // lanes of a dbias block
constexpr int DBIAS_STRIPES = 128;   // row stripes of a dbias block
constexpr int GATHER_THREADS = 320;  // threads of a backward-gather block
constexpr int GATHER_COLS = 8;       // column slots per backward block
constexpr int GATHER_UNROLL = 8;     // rows per thread with loads in flight

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

// a bfloat16 is the top half of a float32: widening is a shift (or a
// mask, for the high half of a pair), narrowing rounds to nearest even as
// __float2bfloat16 does; a pair narrows in one instruction
__device__ __forceinline__ float bf16_bits_to_f32(uint32_t h) {
    return __uint_as_float(h << 16);
}
__device__ __forceinline__ uint32_t f32_to_bf16_bits(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
}
__device__ __forceinline__ uint32_t f32x2_to_bf16x2_bits(float lo,
                                                         float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Pack<__nv_bfloat16, 8> {
    using W = uint4;
    static __device__ __forceinline__ void unpack(W w, float* f) {
        const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = bf16_bits_to_f32(u[i]);
            f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
    }
    static __device__ __forceinline__ W pack(const float* f) {
        uint32_t u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            u[i] = f32x2_to_bf16x2_bits(f[2 * i], f[2 * i + 1]);
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

// v rounded to T, as a float
__device__ __forceinline__ float rounded(float v, const float*) { return v; }
__device__ __forceinline__ float rounded(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16(v));
}

__host__ __device__ constexpr size_t align16(size_t n) {
    return (n + 15) / 16 * 16;
}

// Shared memory of the forward: the slot map, each cell's tap count and
// its <= 9 present taps' rows of y, then for K1 the bias and the groups'
// statistics partials [2][G][R]
__host__ __device__ constexpr size_t cmap_bytes(int tile) {
    return align16(3 * (size_t)(tile + 2) * sizeof(int32_t));
}
__host__ __device__ constexpr size_t taps_bytes(int tile) {
    return align16(10 * (size_t)tile * sizeof(int32_t));
}
__host__ __device__ constexpr size_t bias_bytes(int R) {
    return align16((size_t)R * sizeof(float));
}

template <typename T, bool EPILOGUE, int VEC>
__global__ void __launch_bounds__(MERGE_THREADS, MERGE_MIN_BLOCKS)
merge_kernel(const T* __restrict__ y, const int32_t* __restrict__ col_cy,
             const int32_t* __restrict__ bounds,
             const float* __restrict__ bias, T* __restrict__ out,
             float* __restrict__ partial, int V, int nx, int ny, int R,
             int tile) {
    using P = Pack<T, VEC>;
    using W = typename P::W;
    extern __shared__ __align__(16) unsigned char smem[];
    int32_t* cmap = reinterpret_cast<int32_t*>(smem);
    int32_t* ntaps = reinterpret_cast<int32_t*>(smem + cmap_bytes(tile));
    int32_t* taps = ntaps + tile;   // [tile][9]
    float* bias_s = reinterpret_cast<float*>(
        smem + cmap_bytes(tile) + taps_bytes(tile));
    float* part = reinterpret_cast<float*>(
        smem + cmap_bytes(tile) + taps_bytes(tile) + bias_bytes(R));
    const int width = tile + 2;
    const int oy0 = blockIdx.x * tile;
    const int ox = blockIdx.y;
    const int b = blockIdx.z;
    const int cells = max(0, min(tile, ny - oy0));
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;

    for (int i = tid; i < 3 * width; i += nthreads) cmap[i] = -1;
    if (EPILOGUE)
        for (int i = tid; i < R; i += nthreads) bias_s[i] = __ldg(bias + i);
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
    // each cell's present taps, kh-major, kw-minor: row j * 9 + t of y
    for (int c = tid; c < cells; c += nthreads) {
        int n = 0;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            const int j = cmap[(t / 3) * width + c + t % 3];
            if (j >= 0) taps[c * 9 + n++] = j * 9 + t;
        }
        ntaps[c] = n;
    }
    __syncthreads();

    const int nvec = R / VEC;
    const int G = blockDim.y;
    const W* yb = reinterpret_cast<const W*>(y) + (size_t)b * V * 9 * nvec;
    W* orow = reinterpret_cast<W*>(out)
              + (((size_t)b * nx + ox) * ny + oy0) * nvec;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        // what a cell without taps emits: relu(0.0 + bias), or 0.0
        float rb[VEC], s1[VEC], s2[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            rb[i] = EPILOGUE ? fmaxf(0.f + bias_s[v * VEC + i], 0.f) : 0.f;
            s1[i] = s2[i] = 0.f;
        }
        const W empty = P::pack(rb);
        for (int c = threadIdx.y; c < cells; c += G) {
            const int n = ntaps[c];
            W word = empty;
            if (n == 0) {
                if (EPILOGUE) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        s1[i] += rb[i];
                        s2[i] += rb[i] * rb[i];
                    }
                }
            } else {
                const int32_t* tc = taps + c * 9;
                float acc[VEC];
#pragma unroll
                for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
                for (int k0 = 0; k0 < n; k0 += TAP_BATCH) {
                    W w[TAP_BATCH];
#pragma unroll
                    for (int q = 0; q < TAP_BATCH; ++q)
                        w[q] = k0 + q < n
                            ? __ldg(yb + (size_t)tc[k0 + q] * nvec + v)
                            : W{};
#pragma unroll
                    for (int q = 0; q < TAP_BATCH; ++q) {
                        if (k0 + q < n) {
                            float f[VEC];
                            P::unpack(w[q], f);
#pragma unroll
                            for (int i = 0; i < VEC; ++i) acc[i] += f[i];
                        }
                    }
                }
                if (EPILOGUE) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        acc[i] = fmaxf(acc[i] + bias_s[v * VEC + i], 0.f);
                        s1[i] += acc[i];
                        s2[i] += acc[i] * acc[i];
                    }
                }
                word = P::pack(acc);
            }
            __stcs(orow + (size_t)c * nvec + v, word);
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

// K1 backward, pass 1: pre, and one dbias partial row per block, a block
// per (segment of seg cells, row ox, frame).  Shared memory: the groups'
// partials [G][R].
template <typename T, int VEC>
__global__ void __launch_bounds__(PRE_THREADS)
merge_fused_pre_kernel(const T* __restrict__ out,
                       const T* __restrict__ g_out,
                       const float* __restrict__ g_stats,
                       T* __restrict__ pre, float* __restrict__ partial,
                       int nx, int ny, int R, int seg) {
    using P = Pack<T, VEC>;
    using W = typename P::W;
    extern __shared__ __align__(16) unsigned char smem[];
    float* part = reinterpret_cast<float*>(smem);
    const size_t row = (size_t)blockIdx.z * nx + blockIdx.y;
    const int oy0 = blockIdx.x * seg;
    const int cells = max(0, min(seg, ny - oy0));
    const int nvec = R / VEC;
    const int G = blockDim.y;
    const size_t first = (row * ny + oy0) * nvec;
    const W* orow = reinterpret_cast<const W*>(out) + first;
    const W* grow = reinterpret_cast<const W*>(g_out) + first;
    W* prow = reinterpret_cast<W*>(pre) + first;
    const float* gs = g_stats + row * 2 * R;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        // the stats cotangents enter in T, as the JAX VJP casts them
        float g_sum[VEC], g_sq[VEC], acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            g_sum[i] = rounded(__ldg(gs + v * VEC + i), out);
            g_sq[i] = rounded(__ldg(gs + R + v * VEC + i), out);
            acc[i] = 0.f;
        }
        for (int c0 = threadIdx.y; c0 < cells; c0 += G * PRE_UNROLL) {
            W wo[PRE_UNROLL], wg[PRE_UNROLL];
#pragma unroll
            for (int k = 0; k < PRE_UNROLL; ++k) {
                const int c = c0 + k * G;
                wo[k] = c < cells ? __ldg(orow + (size_t)c * nvec + v) : W{};
                wg[k] = c < cells ? __ldg(grow + (size_t)c * nvec + v) : W{};
            }
#pragma unroll
            for (int k = 0; k < PRE_UNROLL; ++k) {
                const int c = c0 + k * G;
                if (c < cells) {
                    float o[VEC], g[VEC], h[VEC], p[VEC];
                    P::unpack(wo[k], o);
                    P::unpack(wg[k], g);
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        h[i] = g[i] + g_sum[i] + 2.f * o[i] * g_sq[i];
                        h[i] = o[i] > 0.f ? h[i] : 0.f;
                    }
                    // one rounding to T; the sum takes the rounded values
                    const W w = P::pack(h);
                    P::unpack(w, p);
#pragma unroll
                    for (int i = 0; i < VEC; ++i) acc[i] += p[i];
                    prow[(size_t)c * nvec + v] = w;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i)
            part[threadIdx.y * R + v * VEC + i] = acc[i];
    }
    __syncthreads();
    // the block's partial: each lane's G group partials in group order
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    float* dst = partial + (row * gridDim.x + blockIdx.x) * R;
    for (int r = tid; r < R; r += blockDim.x * blockDim.y) {
        float s = 0.f;
        for (int g = 0; g < G; ++g) s += part[g * R + r];
        dst[r] = s;
    }
}

// K1 backward, pass 2: dbias[r] = sum of the n_rows partials of lane r, in
// a fixed order: DBIAS_STRIPES row stripes, then the stripes in order.
__global__ void __launch_bounds__(DBIAS_LANES * DBIAS_STRIPES)
merge_fused_dbias_kernel(const float* __restrict__ partial,
                         float* __restrict__ dbias, int n_rows, int R) {
    __shared__ float part[DBIAS_STRIPES][DBIAS_LANES + 1];
    const int r = blockIdx.x * DBIAS_LANES + threadIdx.x;
    float acc = 0.f;
    if (r < R) {
#pragma unroll 8
        for (int n = threadIdx.y; n < n_rows; n += DBIAS_STRIPES)
            acc += partial[(size_t)n * R + r];
    }
    part[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && r < R) {
        float s = 0.f;
        for (int k = 0; k < DBIAS_STRIPES; ++k) s += part[k][threadIdx.x];
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// elements per word: 16 bytes when every row and tensor allows it
int vector_width(int R, int esize, const void* a, const void* b,
                 const void* c = nullptr) {
    return (R * esize) % 16 == 0 && aligned16(a) && aligned16(b)
            && aligned16(c)
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
    size_t smem = cmap_bytes(tile) + taps_bytes(tile);
    if (fused) smem += bias_bytes(R) + 2 * (size_t)ty * R * sizeof(float);
    return {dim3(tiles, nx, B), dim3(tx, ty), tile, smem};
}

// Launch shape of K1 backward's pass 1: grid (segments, nx, B), block
// (tx, ty), seg cells per segment
struct PreShape {
    dim3 grid, block;
    int seg;
    size_t smem;
};

PreShape pre_shape(int vec, int B, int nx, int ny, int R) {
    const int segs = (ny + PRE_CELLS - 1) / PRE_CELLS;
    const int seg = segs ? (ny + segs - 1) / segs : 0;
    const int nvec = R / vec;
    const int tx = nvec < PRE_THREADS ? nvec : PRE_THREADS;
    int ty = PRE_THREADS / tx;
    if (ty > seg) ty = seg;
    return {dim3(segs, nx, B), dim3(tx, ty), seg,
            (size_t)ty * R * sizeof(float)};
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

template <typename T, int VEC>
int launch_fused_bwd_vec(const void* out, const void* g_out,
                         const void* g_stats, void* pre, void* partial,
                         void* dbias, int B, int nx, int ny, int R,
                         cudaStream_t stream) {
    const auto kernel = merge_fused_pre_kernel<T, VEC>;
    const PreShape s = pre_shape(VEC, B, nx, ny, R);
    if (s.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)s.smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<s.grid, s.block, s.smem, stream>>>(
        (const T*)out, (const T*)g_out, (const float*)g_stats, (T*)pre,
        (float*)partial, nx, ny, R, s.seg);
    int err = (int)cudaGetLastError();
    record_launch(kernel, s.grid, s.block, s.smem);
    if (err != 0) return err;
    const dim3 sum_grid((R + DBIAS_LANES - 1) / DBIAS_LANES),
        sum_block(DBIAS_LANES, DBIAS_STRIPES);
    merge_fused_dbias_kernel<<<sum_grid, sum_block, 0, stream>>>(
        (const float*)partial, (float*)dbias, B * nx * (int)s.grid.x, R);
    err = (int)cudaGetLastError();
    record_launch(merge_fused_dbias_kernel, sum_grid, sum_block, 0);
    return err;
}

template <typename T>
int launch_fused_bwd(const void* out, const void* g_out, const void* g_stats,
                     void* pre, void* partial, void* dbias, int B, int nx,
                     int ny, int R, void* stream) {
    clear_launches();
    constexpr int WIDE = 16 / sizeof(T);
    const int vec = vector_width(R, sizeof(T), out, g_out, pre);
    return vec == WIDE
        ? launch_fused_bwd_vec<T, WIDE>(out, g_out, g_stats, pre, partial,
                                        dbias, B, nx, ny, R,
                                        (cudaStream_t)stream)
        : launch_fused_bwd_vec<T, 1>(out, g_out, g_stats, pre, partial,
                                     dbias, B, nx, ny, R,
                                     (cudaStream_t)stream);
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

// What K1's backward launch needs: facts[0] = dynamic shared bytes of a
// pass-1 block, facts[1] = segments per row (its partial rows per output
// row: the partial scratch is B x nx x segments x R floats)
int merge_fused_bwd_facts(int element_size, int ny, int R, int* facts) {
    const int vec = (R * element_size) % 16 == 0 ? 16 / element_size : 1;
    const PreShape s = pre_shape(vec, 1, 1, ny, R);
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
