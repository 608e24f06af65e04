"""The plain reference of the serving host feed: range and view crop,
projection, the seeded shuffle and the padding, in numpy.

The program's feed (a C++ loop) keeps the points of a raw scan that lie in
the range and in the camera's view, in scan order, shuffles them with a
Fisher-Yates pass driven by ``std::mt19937_64`` seeded with 0 and
``std::uniform_int_distribution<int64_t>(0, i)``, and pads to the
capacity.  The shuffle decides which 35 points of a crowded voxel are
kept, so the reference draws the same permutation: MT19937-64 as its
authors define it, and the draw of libstdc++'s distribution for a 64-bit
generator (Lemire's multiply-and-keep-the-high-word, with its rejection
step).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_N, _M = 312, 156
_MATRIX_A = np.uint64(0xB5026F5AA96619E9)
_UPPER = np.uint64(0xFFFFFFFF80000000)
_LOWER = np.uint64(0x7FFFFFFF)


class MT19937_64:
    """The 64-bit Mersenne Twister (Matsumoto and Nishimura, 2004), the
    generator ``std::mt19937_64`` is."""

    def __init__(self, seed: int):
        mt = [0] * _N
        mt[0] = seed & 0xFFFFFFFFFFFFFFFF
        for i in range(1, _N):
            prev = mt[i - 1]
            mt[i] = (6364136223846793005 * (prev ^ (prev >> 62)) + i) \
                & 0xFFFFFFFFFFFFFFFF
        self.mt = np.array(mt, dtype=np.uint64)
        self.index = _N

    def _twist(self) -> None:
        mt = self.mt
        # the recurrence reads words that the same pass rewrites, so it
        # runs in three vectorised spans, as the C++ loop's order needs
        for lo, hi in ((0, _N - _M), (_N - _M, _N - 1)):
            x = (mt[lo:hi] & _UPPER) | (mt[lo + 1:hi + 1] & _LOWER)
            xa = (x >> np.uint64(1)) ^ np.where(
                (x & np.uint64(1)).astype(bool), _MATRIX_A, np.uint64(0))
            if lo == 0:
                mt[lo:hi] = mt[lo + _M:hi + _M] ^ xa
            else:
                # mt[i + M - N] for i in [N - M, N - 1): indices 0.. already
                # rewritten by the first span
                mt[lo:hi] = mt[lo + _M - _N:hi + _M - _N] ^ xa
        x = (mt[_N - 1] & _UPPER) | (mt[0] & _LOWER)
        xa = (x >> np.uint64(1)) ^ (_MATRIX_A if int(x) & 1 else np.uint64(0))
        mt[_N - 1] = mt[_M - 1] ^ xa
        self.index = 0

    def block(self, n: int) -> np.ndarray:
        """The next ``n`` outputs, tempered, as uint64."""
        out = []
        while n > 0:
            if self.index >= _N:
                self._twist()
            take = min(n, _N - self.index)
            y = self.mt[self.index:self.index + take].copy()
            self.index += take
            n -= take
            y ^= (y >> np.uint64(29)) & np.uint64(0x5555555555555555)
            y ^= (y << np.uint64(17)) & np.uint64(0x71D67FFFEDA60000)
            y ^= (y << np.uint64(37)) & np.uint64(0xFFF7EEE000000000)
            y ^= y >> np.uint64(43)
            out.append(y)
        return np.concatenate(out) if out else np.zeros(0, np.uint64)


def _mul_hi_lo(x: np.ndarray, r: np.ndarray):
    """High and low 64-bit words of x * r for uint64 x and r < 2**32."""
    mask = np.uint64(0xFFFFFFFF)
    xl, xh = x & mask, x >> np.uint64(32)
    lo_p = xl * r
    mid = xh * r + (lo_p >> np.uint64(32))
    hi = mid >> np.uint64(32)
    lo = (mid << np.uint64(32)) | (lo_p & mask)
    return hi, lo


def fisher_yates_draws(n: int, seed: int = 0) -> np.ndarray:
    """The j drawn for i = n-1 down to 1 by the host feed's shuffle:
    ``uniform_int_distribution(0, i)`` on ``mt19937_64(seed)``."""
    if n <= 1:
        return np.zeros(0, np.int64)
    gen = MT19937_64(seed)
    ranges = np.arange(n, 1, -1, dtype=np.uint64)          # i + 1
    x = gen.block(len(ranges))
    hi, lo = _mul_hi_lo(x, ranges)
    bad = np.nonzero(lo < ranges)[0]
    if len(bad) == 0:
        return hi.astype(np.int64)
    # the rejection step, taken where the low word falls under the
    # threshold: from there on, draws shift by the extra outputs
    out = np.empty(len(ranges), np.int64)
    out[:bad[0]] = hi[:bad[0]]
    gen = MT19937_64(seed)
    gen.block(int(bad[0]))
    for k in range(int(bad[0]), len(ranges)):
        r = int(ranges[k])
        v = int(gen.block(1)[0])
        prod = v * r
        low = prod & 0xFFFFFFFFFFFFFFFF
        if low < r:
            threshold = (-r) % r
            while low < threshold:
                v = int(gen.block(1)[0])
                prod = v * r
                low = prod & 0xFFFFFFFFFFFFFFFF
        out[k] = prod >> 64
    return out


def shuffle_order(n: int, seed: int = 0) -> np.ndarray:
    """The permutation the host feed's shuffle applies: row k of the
    shuffled cloud is row ``order[k]`` of the cropped one."""
    order = np.arange(n, dtype=np.int64)
    draws = fisher_yates_draws(n, seed)
    for i, j in zip(range(n - 1, 0, -1), draws.tolist()):
        order[i], order[j] = order[j], order[i]
    return order


def crop_project(scan: np.ndarray, rect: np.ndarray, proj: np.ndarray,
                 velo_range, image_hw) -> np.ndarray:
    """(N, 4) scan -> (K, 6) [x y z refl row col] of the points in the
    half-open range and in the view (positive depth, ``0 <= uv < size -
    1e-3``), in scan order; computed in float64, row and col rounded to
    float32 once."""
    pts = np.asarray(scan[:, :4], np.float32)
    lo = np.asarray(velo_range[:3], np.float32)
    hi = np.asarray(velo_range[3:6], np.float32)
    keep = np.all((pts[:, :3] >= lo) & (pts[:, :3] < hi), axis=1)
    pts = pts[keep]
    hom = np.concatenate([pts[:, :3].astype(np.float64),
                          np.ones((len(pts), 1))], axis=1)
    depth = (hom @ rect.astype(np.float64).T)[:, 2]
    img = hom @ proj.astype(np.float64).T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = img[:, :2] / img[:, 2:3]
    h, w = image_hw
    ok = ((depth > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w - 1e-3)
          & (uv[:, 1] >= 0) & (uv[:, 1] < h - 1e-3))
    return np.concatenate([pts[ok], uv[ok, 1:2], uv[ok, 0:1]],
                          axis=1).astype(np.float32)


def assemble(scan: np.ndarray, rect: np.ndarray, proj: np.ndarray,
             velo_range, image_hw, capacity: int
             ) -> Tuple[np.ndarray, int]:
    """One frame of the feed: (points (capacity, 6), real rows)."""
    cloud = crop_project(scan, rect, proj, velo_range, image_hw)
    cloud = cloud[shuffle_order(len(cloud))]
    n = min(len(cloud), capacity)
    out = np.zeros((capacity, 6), np.float32)
    out[:n] = cloud[:n]
    return out, n
