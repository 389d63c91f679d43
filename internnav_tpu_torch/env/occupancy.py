"""Top-down occupancy maps for collision-checked teleport controllers.

Reference parity: the VLN-PE flash-with-collision controller builds a
binary free-space map from a top-down depth camera and checks teleport
targets against it
(internnav/env/utils/internutopia_extension/controllers/
vln_move_by_flash_with_collision_controller.py:103-160) using the
map-pixel<->world transforms in evaluator/utils/path_plan.py:14-42.

This module supplies the same pieces decoupled from Isaac: pure
transforms, the height-band free-space extraction, and a factory that
turns (depth provider, camera pose) into the `is_occupied(x, y)`
callable consumed by env/controllers.py:FlashCollisionController — so
the sim extension only wires sensors, and everything here is testable
headlessly.

Copy of internnav_tpu/env/occupancy.py,
kept in the port so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

#: reference default: 10 map pixels per (aperture/width) world units
_SCALE = 10.0


def world_to_map_pixel(world_xy: Sequence[float], camera_xy: Sequence[float],
                       aperture: float, width: int,
                       height: int) -> Tuple[float, float]:
    """World (x, y) → top-down map pixel (row, col): scale by
    10/aperture, recenter on the camera, flip the row axis
    (path_plan.py:28-42 semantics). The depth image is (height, width):
    world x maps to the ROW (scaled by height), world y to the COLUMN
    (scaled by width) — the reference mixes width into the row formula,
    which only coincides with its own inverse at square resolutions;
    here the pair is an exact inverse at any resolution (and equals the
    reference at the square 500x500 map it ships)."""
    c_row = camera_xy[0] * _SCALE / aperture * height
    c_col = -camera_xy[1] * _SCALE / aperture * width
    row_w = world_xy[0] * _SCALE / aperture * height
    col_w = -world_xy[1] * _SCALE / aperture * width
    row = height - (row_w - c_row + height / 2.0)
    col = col_w - c_col + width / 2.0
    return row, col


def map_pixel_to_world(pixel_xy: Sequence[float], camera_xy: Sequence[float],
                       aperture: float, width: int,
                       height: int) -> Tuple[float, float]:
    """Exact inverse of world_to_map_pixel (path_plan.py:14-26)."""
    c_row = camera_xy[0] * _SCALE / aperture * height
    c_col = -camera_xy[1] * _SCALE / aperture * width
    row_w = height - pixel_xy[0] + c_row - height / 2.0
    col_w = pixel_xy[1] + c_col - width / 2.0
    world_x = row_w / _SCALE / height * aperture
    world_y = -col_w / _SCALE / width * aperture
    return world_x, world_y


def free_map_from_topdown_depth(depth: np.ndarray, base_height: float,
                                robot_type: str = "h1",
                                ankle_height: Optional[float] = None,
                                max_height: float = 1.55 + 8) -> np.ndarray:
    """Binary free-space map (1 = free, 0 = occupied/invalid) from a
    top-down depth image, by the reference's per-robot height bands
    (vln_move_by_flash_with_collision_controller.py:120-137):

    - h1: free where depth in [base+0.6, max) — standing clearance — or
      in (0.02, 0.5] (floor readings right under the camera);
    - aliengo: free where depth in [base-ankle+0.05, max).
    """
    depth = np.asarray(depth, np.float32)
    if robot_type == "aliengo":
        lo = base_height - float(ankle_height or 0.0) + 0.05
        mask = (depth >= lo) & (depth < max_height)
    else:
        lo = base_height + 0.6
        mask = ((depth >= lo) & (depth < max_height)) \
            | ((depth <= 0.5) & (depth > 0.02))
    return mask.astype(np.int32)


def make_occupancy_checker(get_depth: Callable[[], np.ndarray],
                           get_camera_xy: Callable[[], Sequence[float]],
                           get_base_height: Callable[[], float],
                           resolution: Tuple[int, int],
                           aperture: float = 200.0,
                           robot_type: str = "h1",
                           get_ankle_height: Optional[Callable[[], float]] = None,
                           robot_size: int = 3) -> Callable[[float, float], bool]:
    """Build the `is_occupied(x, y)` callable for
    FlashCollisionController: refresh the free map from the current
    top-down depth, project the world target to a map (row, col), and
    report occupied when ANY cell of the (2*robot_size)^2 footprint is
    not free (reference check_collision, :139-160). Out-of-map targets
    count as occupied (the reference would index out of bounds there).
    `resolution` is (width, height), matching the camera config; the
    depth image is (height, width)."""
    width, height = int(resolution[0]), int(resolution[1])

    def is_occupied(x: float, y: float) -> bool:
        free = free_map_from_topdown_depth(
            get_depth(), get_base_height(), robot_type,
            ankle_height=get_ankle_height() if get_ankle_height else None)
        row, col = world_to_map_pixel((x, y), get_camera_xy(), aperture,
                                      width, height)
        r_i, c_i = int(row), int(col)
        lo_r, hi_r = r_i - robot_size, r_i + robot_size
        lo_c, hi_c = c_i - robot_size, c_i + robot_size
        if lo_r < 0 or lo_c < 0 or hi_r > free.shape[0] or hi_c > free.shape[1]:
            return True
        return bool(np.any(free[lo_r:hi_r, lo_c:hi_c] == 0))

    return is_occupied
