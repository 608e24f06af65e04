"""Calibration matrices and box geometry."""

from mvxnet_makise_tpu_torch.geometry.boxes import (  # noqa: F401
    aligned_bbox_intersection,
    boxes3d_to_bev_corners,
    boxes3d_to_corners3d,
    boxes_cam_to_lidar,
    boxes_lidar_to_cam,
    decode_boxes,
    encode_boxes,
    polygon_area,
    quad_intersection_area,
    rotated_iou_bev,
)
from mvxnet_makise_tpu_torch.geometry.calib import (  # noqa: F401
    Calib,
    lidar_to_cam_rect,
    lidar_to_image,
    read_calib,
    rect_to_lidar,
)
