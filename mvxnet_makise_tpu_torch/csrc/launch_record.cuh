// What the last call of a library's entry point launched: for each kernel,
// its grid, block and dynamic shared memory, the registers and local
// (spill) memory per thread that ptxas gave it (read back with
// cudaFuncGetAttributes), and how many of its blocks fit one SM at that
// launch (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Every csrc/*.cu
// includes this header once: each source is its own shared library, so
// each keeps its own record, exported as last_launches() (launch_fields()
// ints per launch).  An entry point calls clear_launches() first and
// record_launch() after each launch.

#pragma once

#include <cuda_runtime.h>

namespace {

// grid x, y, z; block x, y, z; dynamic shared bytes; registers per
// thread; local bytes per thread; static shared bytes; blocks per SM
constexpr int LAUNCH_FIELDS = 11;
constexpr int MAX_LAUNCHES = 4;
int n_launches = 0;
int launch_facts[MAX_LAUNCHES][LAUNCH_FIELDS];

void clear_launches() { n_launches = 0; }

template <typename Kernel>
void record_launch(Kernel kernel, dim3 grid, dim3 block, size_t smem) {
    if (n_launches == MAX_LAUNCHES) return;
    int regs = -1, local = -1, shared = -1, blocks = -1;
    cudaFuncAttributes a = {};
    if (cudaFuncGetAttributes(&a, kernel) == cudaSuccess) {
        regs = a.numRegs;
        local = (int)a.localSizeBytes;
        shared = (int)a.sharedSizeBytes;
    } else {
        cudaGetLastError();   // not a launch error: leave none behind
    }
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, (int)(block.x * block.y * block.z), smem)
        != cudaSuccess) {
        blocks = -1;
        cudaGetLastError();
    }
    const int v[LAUNCH_FIELDS] = {
        (int)grid.x, (int)grid.y, (int)grid.z, (int)block.x, (int)block.y,
        (int)block.z, (int)smem, regs, local, shared, blocks};
    int* r = launch_facts[n_launches++];
    for (int i = 0; i < LAUNCH_FIELDS; ++i) r[i] = v[i];
}

}  // namespace

extern "C" int launch_fields() { return LAUNCH_FIELDS; }

extern "C" int last_launches(int* out, int capacity) {
    const int n = n_launches < capacity ? n_launches : capacity;
    for (int k = 0; k < n; ++k)
        for (int i = 0; i < LAUNCH_FIELDS; ++i)
            out[k * LAUNCH_FIELDS + i] = launch_facts[k][i];
    return n;
}
