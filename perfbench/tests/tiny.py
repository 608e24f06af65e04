"""A tiny size of each cell for the CPU tests: the shipped configuration
with a small grid, image and capacity, and a small pool."""

TINY = {
    "config": {"voxelshape": [32, 40, 10], "imsize": [64, 96],
               "image_min_side": 0, "max_points": 1024, "max_voxels": 256,
               "samplenum": 8, "assign_window": 6},
    "traffic": {"view_points": [800, 1200], "out_of_view_points": [2000, 3000],
                "pool": 8, "check_frames": 2, "traced_frames": 8,
                "host_feed_batches": 2, "warm_frames": 1, "rate_hz": 20,
                "traced_steps": 2, "batch": 2},
}
