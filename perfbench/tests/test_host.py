"""The reference's host feed draws the program's shuffle: MT19937-64 and
libstdc++'s uniform_int_distribution, against the program's C++ feed."""

import numpy as np
import pytest

from perfbench import generate
from perfbench.reference import host

RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
IMAGE = (370, 1224)


def test_mt19937_64_known_output():
    # the C++ standard requires the 10000th output of a default-seeded
    # (5489) mt19937_64 to be 9981545732273789042
    gen = host.MT19937_64(5489)
    assert int(gen.block(10000)[-1]) == 9981545732273789042


def test_shuffle_equals_the_programs_feed():
    from mvxnet_makise_tpu_torch.data import native
    from mvxnet_makise_tpu_torch.geometry.calib import Calib

    if not native.available():
        pytest.skip("the program's C++ host feed did not build here")
    mix = {"edge_margin_px": 0.01, "edge_margin_m": 0.001,
           "view_points": [14000, 24000], "out_of_view_points": [2000, 4000],
           "cars_in_view": 8, "cars_out_of_view": 2, "car_share": 0.25,
           "wall_share": 0.15, "images": False, "pool": 2}
    for f in generate.make_pool(2 ** 40 + 3, mix, RANGE, IMAGE,
                                (3.9, 1.6, 1.56)):
        cal = Calib(velo_to_cam=f.camera.velo_to_cam, P2=f.camera.P2,
                    R0=f.camera.R0)
        buf, n = native.assemble_frame(f.scan, cal, RANGE, IMAGE, 32768)
        ref, rn = host.assemble(f.scan, f.camera.rect, f.camera.proj, RANGE,
                                IMAGE, 32768)
        assert n == rn
        assert np.array_equal(buf[:, :4], ref[:, :4])
        assert np.abs(buf[:, 4:] - ref[:, 4:]).max() < 1e-3
