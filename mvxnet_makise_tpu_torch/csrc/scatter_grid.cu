// K4: voxel rows -> dense channels-last grid, for Hopper (sm_90a), with
// its backward.
//
// Replaces the TPU kernel pallas_scatter_to_grid in
// mvxnet_makise_tpu/ops/pallas_scatter.py (Pallas body _kernel) and the
// custom VJP _pallas_scatter_bwd in mvxnet_makise_tpu/models/voxelnet.py.
// Its plain PyTorch version is scatter_voxels_to_grid in ops/scatter.py.
//
// What it computes.  Per frame b, V voxel rows features[b, v, :] of C
// channels sit at unique cells flat(v) = iz*nx*ny + ix*ny + iy; masked rows
// drop.  The output is the dense (nz, nx, ny, C) grid: grid[b, flat(v)] =
// features[b, v], every other cell 0.  The backward is a masked row
// gather: d_features[b, v] = g[b, flat(v)] for a valid row, else 0.
//
// What bounds it on this card: memory.  The forward writes the whole grid
// (about 721 MB per frame at the default config in float32) and reads the
// V rows once; the backward reads V rows of the grid's cotangent and
// writes V rows.
//
// Design.  The wrapper sorts each frame's cell ids (V = 12k keys, invalid
// rows keyed INT_MAX so they sort last) and finds, for each chunk of
// `chunk` consecutive cells, its range of sorted rows (one searchsorted:
// the TPU kernel's prefetched starts).  One block per (frame, chunk) reads
// its two bounds, builds a `chunk`-entry shared-memory map cell -> row
// (-1 = empty), and then writes every cell of its chunk exactly
// once: each warp takes one cell at a time and its lanes store the row's
// 16-byte words, or zeros, on consecutive addresses (a 128-channel float32
// row is one 512-byte store per warp).  The kernel zero-fills the grid
// itself, as the TPU kernel does in its body: no memset, no second pass.
// Cells are unique, so no two rows meet and there are no atomics.  Rows are
// copied as raw 16-byte words, so any dtype whose row is a multiple of 16
// bytes works.  The backward gives one warp to each row.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_record.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void scatter_grid_kernel(const uint4* __restrict__ features,
                                    const int32_t* __restrict__ order,
                                    const int32_t* __restrict__ sorted_cell,
                                    const int32_t* __restrict__ starts,
                                    uint4* __restrict__ grid, int V,
                                    int n_cells, int chunk, int words) {
    extern __shared__ int32_t rowmap[];   // chunk entries
    const int c0 = blockIdx.x * chunk;
    const int b = blockIdx.y;
    const int32_t* sc = sorted_cell + (size_t)b * V;
    const int32_t* ob = order + (size_t)b * V;
    const int32_t* st = starts + (size_t)b * (gridDim.x + 1) + blockIdx.x;
    const int lo = st[0], hi = st[1];
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) rowmap[i] = -1;
    __syncthreads();
    for (int j = lo + threadIdx.x; j < hi; j += blockDim.x)
        rowmap[sc[j] - c0] = ob[j];
    __syncthreads();

    const int cells = min(chunk, n_cells - c0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const uint4* fb = features + (size_t)b * V * words;
    uint4* gb = grid + ((size_t)b * n_cells + c0) * words;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int c = warp; c < cells; c += WARPS) {
        const int row = rowmap[c];
        uint4* dst = gb + (size_t)c * words;
        if (row >= 0) {
            const uint4* src = fb + (size_t)row * words;
            for (int w = lane; w < words; w += 32) dst[w] = src[w];
        } else {
            for (int w = lane; w < words; w += 32) dst[w] = zero;
        }
    }
}

__global__ void scatter_grid_bwd_kernel(const uint4* __restrict__ g,
                                        const int32_t* __restrict__ coords,
                                        const uint8_t* __restrict__ mask,
                                        uint4* __restrict__ d_features,
                                        int rows, int V, int nx, int ny,
                                        int nz, int words) {
    const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x)
                          / 32);
    const int lane = threadIdx.x % 32;
    if (row >= rows) return;
    uint4* dst = d_features + (size_t)row * words;
    if (mask[row]) {
        const int32_t* c = coords + (size_t)row * 3;
        const size_t cell = (size_t)(row / V) * nx * ny * nz
                            + (size_t)c[2] * nx * ny + (size_t)c[0] * ny
                            + c[1];
        const uint4* src = g + cell * words;
        for (int w = lane; w < words; w += 32) dst[w] = src[w];
    } else {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (int w = lane; w < words; w += 32) dst[w] = zero;
    }
}

}  // namespace

extern "C" {

// features (B, V, C) with row_bytes = C * element size, a multiple of 16;
// order, sorted_cell (B, V) int32; starts (B, n_chunks + 1) int32, the
// first sorted row of each chunk of `chunk` cells; grid (B, n_cells, C)
int scatter_grid(const void* features, const void* order,
                 const void* sorted_cell, const void* starts, void* grid,
                 int B, int V, int n_cells, int chunk, int row_bytes,
                 void* stream) {
    const dim3 blocks((n_cells + chunk - 1) / chunk, B);
    clear_launches();
    scatter_grid_kernel<<<blocks, THREADS, chunk * sizeof(int32_t),
                          (cudaStream_t)stream>>>(
        (const uint4*)features, (const int32_t*)order,
        (const int32_t*)sorted_cell, (const int32_t*)starts, (uint4*)grid,
        V, n_cells, chunk, row_bytes / 16);
    const int err = (int)cudaGetLastError();
    record_launch(scatter_grid_kernel, blocks, dim3(THREADS),
                  chunk * sizeof(int32_t));
    return err;
}

// g (B, nz*nx*ny, C); coords (B, V, 3) int32 (ix, iy, iz); mask (B, V)
// bool; d_features (B, V, C)
int scatter_grid_bwd(const void* g, const void* coords, const void* mask,
                     void* d_features, int B, int V, int nx, int ny, int nz,
                     int row_bytes, void* stream) {
    const int rows = B * V;
    const int blocks = (rows + WARPS - 1) / WARPS;
    clear_launches();
    scatter_grid_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)g, (const int32_t*)coords, (const uint8_t*)mask,
        (uint4*)d_features, rows, V, nx, ny, nz, row_bytes / 16);
    const int err = (int)cudaGetLastError();
    record_launch(scatter_grid_bwd_kernel, dim3(blocks), dim3(THREADS), 0);
    return err;
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
