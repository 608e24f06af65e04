// Native host-side point-cloud kernels (C++17, OpenMP-free, ctypes ABI).
//
// The port's own copy of mvxnet_makise_tpu/csrc/pointcloud.cpp (same code;
// bound by data/native.py).  Voxel grouping, IoU and anchor work run on the
// device (ops/voxelize.py, geometry/boxes.py), so the native layer covers
// what is still host work on the feed path:
//
//   * fused range + camera-frustum crop with image projection
//     (the hot inner loop of the cropdata offline tool and the online
//     loader — reference Preprocessing.py:12-55 crop/cropToSight,
//     Calib.py:47-70 lidar2Img, run per frame per epoch),
//   * padded-buffer assembly (crop + project + shuffle + pad in one pass,
//     writing straight into the static-capacity arrays the device
//     consumes — data/pipeline.py's FrameArrays layout).
//
// Built with plain g++ into a shared object; Python binds via ctypes
// (no pybind11 in this image).  All matrices are row-major float32.

#include <cstdint>
#include <cstring>
#include <random>

extern "C" {

// y = M (4x4, row-major) * x (homogeneous [x,y,z,1])
static inline void mat4_apply(const float* m, const float* p, float* out) {
    for (int r = 0; r < 4; ++r) {
        out[r] = m[r * 4 + 0] * p[0] + m[r * 4 + 1] * p[1] +
                 m[r * 4 + 2] * p[2] + m[r * 4 + 3];
    }
}

// Fused range crop + frustum crop + projection.
//
// points:   (n, 4) [x y z refl]
// rect:     (4, 4) R0 @ Tr_velo_to_cam
// proj:     (4, 4) P2 @ R0 @ Tr_velo_to_cam
// range6:   [x0 y0 z0 x1 y1 z1]
// imsize:   [h, w]
// out:      (n, 6) buffer — kept points as [x y z refl row col]
// returns:  number of kept points
//
// Boundary semantics match the reference exactly: half-open range
// [low, high) (Preprocessing.py:12-17) and the image bound
// "0 <= uv < imsize - 1e-3" with positive camera depth
// (Preprocessing.py:34-55).
int64_t crop_project(const float* points, int64_t n,
                     const float* rect, const float* proj,
                     const float* range6, const float* imsize,
                     float* out) {
    const float x0 = range6[0], y0 = range6[1], z0 = range6[2];
    const float x1 = range6[3], y1 = range6[4], z1 = range6[5];
    const float hlim = imsize[0] - 1e-3f, wlim = imsize[1] - 1e-3f;

    int64_t kept = 0;
    float hom[4], cam[4], img[4];
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * 4;
        if (p[0] < x0 || p[0] >= x1 || p[1] < y0 || p[1] >= y1 ||
            p[2] < z0 || p[2] >= z1)
            continue;
        hom[0] = p[0]; hom[1] = p[1]; hom[2] = p[2]; hom[3] = 1.0f;
        mat4_apply(rect, hom, cam);
        if (cam[2] <= 0.0f) continue;               // behind the camera
        mat4_apply(proj, hom, img);
        const float inv_z = 1.0f / img[2];
        const float u = img[0] * inv_z;             // width coordinate
        const float v = img[1] * inv_z;             // height coordinate
        if (u < 0.0f || u >= wlim || v < 0.0f || v >= hlim) continue;
        float* o = out + kept * 6;
        o[0] = p[0]; o[1] = p[1]; o[2] = p[2]; o[3] = p[3];
        o[4] = v;                                   // row
        o[5] = u;                                   // col
        ++kept;
    }
    return kept;
}

// Range crop only (the cropdata "numpy mode" inner loop,
// Preprocessing.py:12-17).  out: (n, 4).  Returns kept count.
int64_t crop_range(const float* points, int64_t n, const float* range6,
                   float* out) {
    const float x0 = range6[0], y0 = range6[1], z0 = range6[2];
    const float x1 = range6[3], y1 = range6[4], z1 = range6[5];
    int64_t kept = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * 4;
        if (p[0] < x0 || p[0] >= x1 || p[1] < y0 || p[1] >= y1 ||
            p[2] < z0 || p[2] >= z1)
            continue;
        std::memcpy(out + kept * 4, p, 4 * sizeof(float));
        ++kept;
    }
    return kept;
}

// One-pass feed assembly: crop+project (as crop_project), then
// Fisher-Yates shuffle with the given seed, truncate/pad to `capacity`
// rows, writing zeros into the tail.  Returns the number of real rows.
int64_t assemble_frame(const float* points, int64_t n,
                       const float* rect, const float* proj,
                       const float* range6, const float* imsize,
                       uint64_t seed, int64_t capacity, float* out) {
    int64_t kept = crop_project(points, n, rect, proj, range6, imsize, out);
    std::mt19937_64 rng(seed);
    if (kept > 1) {
        for (int64_t i = kept - 1; i > 0; --i) {
            std::uniform_int_distribution<int64_t> dist(0, i);
            int64_t j = dist(rng);
            if (j != i) {
                float tmp[6];
                std::memcpy(tmp, out + i * 6, 6 * sizeof(float));
                std::memcpy(out + i * 6, out + j * 6, 6 * sizeof(float));
                std::memcpy(out + j * 6, tmp, 6 * sizeof(float));
            }
        }
    }
    int64_t real = kept < capacity ? kept : capacity;
    if (real < capacity)
        std::memset(out + real * 6, 0, (capacity - real) * 6 * sizeof(float));
    return real;
}

}  // extern "C"
