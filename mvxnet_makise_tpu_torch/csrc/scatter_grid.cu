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
// What bounds it on this card: memory, and almost all of it is the grid's
// write.  The forward writes the whole grid (about 721 MB per frame at the
// default config in float32) and reads the V rows once; the backward reads
// V rows of the grid's cotangent and writes V rows.
//
// Design.  The grid is written at the rate of a plain zero fill, which on
// an H100 is the rate of small blocks writing consecutive memory in block
// order: any load before a block's first store (a bitmap of occupied
// cells, a cell -> row map, sorted row bounds), or a large range per
// block, measured slower.  So the forward is two launches in stream order
// and nothing else: no sort, no scratch.
//   1. scatter_fill_kernel zeroes every 16-byte word of the grid, one
//      FILL_BYTES range per block, 16-byte stores on consecutive lanes.
//   2. scatter_rows_kernel gives one thread to each 16-byte word of each
//      row.  It issues its loads (the mask, the coords, the word) before
//      any branch, so one memory latency covers them, and stores the word
//      at its cell if the row is valid and its cell inside the grid.
// A valid row's cell is written twice, zeros and then the row: V rows
// against the grid's n_cells (12,288 of 1.4 M cells per frame, 0.9 % more
// bytes).  Rows may come in any order; masked rows never write.  Cells are
// unique, so no two rows meet and there are no atomics.  Rows are copied
// as raw 16-byte words, so any dtype whose row is a multiple of 16 bytes
// works, and offsets are size_t (a batch of grids passes 2^31 bytes).  The
// backward gives one warp to each row.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_record.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// grid bytes zeroed per block of the fill
constexpr size_t FILL_BYTES = 8192;
constexpr size_t FILL_WORDS = FILL_BYTES / 16;

__global__ void scatter_fill_kernel(uint4* __restrict__ grid, size_t words) {
    const size_t lo = (size_t)blockIdx.x * FILL_WORDS;
    const size_t hi = lo + FILL_WORDS < words ? lo + FILL_WORDS : words;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x) grid[i] = zero;
}

__global__ void scatter_rows_kernel(const uint4* __restrict__ features,
                                    const int32_t* __restrict__ coords,
                                    const uint8_t* __restrict__ mask,
                                    uint4* __restrict__ grid, size_t total,
                                    int V, int nx, int ny, int n_cells,
                                    int words) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const size_t row = i / words;
    const int w = (int)(i - row * words);
    const uint8_t valid = mask[row];
    const int32_t* c = coords + row * 3;
    const int ix = c[0], iy = c[1], iz = c[2];
    const uint4 v = features[i];
    const long long cell = (long long)iz * nx * ny + (long long)ix * ny + iy;
    if (!valid || cell < 0 || cell >= n_cells) return;
    grid[((row / V) * n_cells + cell) * words + w] = v;
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
// coords (B, V, 3) int32 (ix, iy, iz); mask (B, V) bool; grid (B, nz*nx*ny,
// C), written whole
int scatter_grid(const void* features, const void* coords, const void* mask,
                 void* grid, int B, int V, int nx, int ny, int nz,
                 int row_bytes, void* stream) {
    const int n_cells = nx * ny * nz;
    const int words = row_bytes / 16;
    const size_t grid_words = (size_t)B * n_cells * words;
    const size_t row_words = (size_t)B * V * words;
    const dim3 fill_blocks((unsigned)((grid_words + FILL_WORDS - 1)
                                      / FILL_WORDS));
    const dim3 row_blocks((unsigned)((row_words + THREADS - 1) / THREADS));
    cudaStream_t st = (cudaStream_t)stream;
    clear_launches();
    scatter_fill_kernel<<<fill_blocks, THREADS, 0, st>>>((uint4*)grid,
                                                         grid_words);
    int err = (int)cudaGetLastError();
    record_launch(scatter_fill_kernel, fill_blocks, dim3(THREADS), 0);
    if (err || row_words == 0) return err;
    scatter_rows_kernel<<<row_blocks, THREADS, 0, st>>>(
        (const uint4*)features, (const int32_t*)coords, (const uint8_t*)mask,
        (uint4*)grid, row_words, V, nx, ny, n_cells, words);
    err = (int)cudaGetLastError();
    record_launch(scatter_rows_kernel, row_blocks, dim3(THREADS), 0);
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
