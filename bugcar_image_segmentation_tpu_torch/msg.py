"""ROS-free occupancy-grid message construction (+ optional rospy adapter).

The port's copy of ``bugcar_image_segmentation_tpu/msg.py`` (numpy only;
the port imports nothing of the JAX package).  The reference's only
inter-process surface is publishing a
``nav_msgs/OccupancyGrid`` (reference occgrid_to_ros.py:13-61).  Its
semantics, reproduced here without any ROS dependency:

- image→map reorientation: vertical flip then 90° CCW rotation, so the
  grid's first axis points along the vehicle's +x (forward) and the second
  along +y (left) (reference :18-24);
- metadata width/height deliberately swapped relative to the metric
  width/height arguments, matching that rotation (reference :39-41);
- origin = the (0,0)-cell position ``[0, -W/2, 0] + pose[:3]`` rotated
  into the target frame, orientation = the pose's Euler xyz angles as a
  quaternion (reference :27-31, :47-58).

The core returns a plain :class:`OccupancyGridMessage` dataclass — numpy
data + metadata — which the navigation stack side can consume directly or
convert with :func:`to_rospy_msg` when rospy exists.  Rotation math is
self-contained (no scipy): intrinsic-xyz Euler → quaternion/matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Rotation helpers (scipy-free)
# ---------------------------------------------------------------------------


def euler_xyz_to_quaternion(angles: Sequence[float]) -> np.ndarray:
    """Intrinsic-xyz Euler angles (radians) → quaternion (x, y, z, w).

    Matches ``scipy...Rotation.from_euler("xyz", angles).as_quat()``
    (the reference's convention, occgrid_to_ros.py:27-28).
    """
    rx, ry, rz = (float(a) / 2.0 for a in angles)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    # q = qz ⊗ qy ⊗ qx for intrinsic xyz (≡ extrinsic z-y-x composition).
    return np.array([
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz,
    ])


def quaternion_to_matrix(q: Sequence[float]) -> np.ndarray:
    """Quaternion (x, y, z, w) → 3x3 rotation matrix."""
    x, y, z, w = (float(v) for v in q)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def euler_xyz_to_matrix(angles: Sequence[float]) -> np.ndarray:
    return quaternion_to_matrix(euler_xyz_to_quaternion(angles))


# ---------------------------------------------------------------------------
# The message
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OccupancyGridMessage:
    """A ``nav_msgs/OccupancyGrid`` as plain data.

    ``data`` is the row-major int8 cell array after image→map
    reorientation; ``width``/``height`` are in cells (already swapped the
    way the reference swaps them); ``origin_*`` locate cell (0, 0) in the
    target frame.
    """

    data: np.ndarray            # int8, flattened (height * width)
    width: int                  # cells along map x
    height: int                 # cells along map y
    resolution: float           # meters per cell
    origin_position: np.ndarray      # (3,) meters
    origin_orientation: np.ndarray   # (4,) quaternion x, y, z, w
    frame_id: str = "base_link"
    stamp: Optional[float] = None    # seconds (caller-supplied clock)

    def grid2d(self) -> np.ndarray:
        """The reoriented grid as (height, width) int8."""
        return self.data.reshape(self.height, self.width)


def to_occupancy_grid_msg(occ_grid: np.ndarray,
                          map_resolution: float,
                          map_width: float,
                          map_height: float,
                          time_stamp: Optional[float] = None,
                          frame_id: str = "base_link",
                          pose: Sequence[float] = (0.0,) * 6,
                          ) -> OccupancyGridMessage:
    """Build the message exactly as reference occgrid_to_ros.py:13-61.

    Args:
      occ_grid: (H, W) int8 grid from the pipeline (image orientation).
      map_resolution: meters per cell.
      map_width/map_height: metric grid extent (meters).
      time_stamp: seconds; forwarded to the header.
      frame_id: target frame.
      pose: [x, y, z, roll, pitch, yaw] of the BEV frame in the target
        frame.
    """
    occ_grid = np.asarray(occ_grid, dtype=np.int8)
    # Image → map orientation: flip vertically, then rotate 90° CCW
    # (reference :18-21).  np.rot90 k=1 == cv2.ROTATE_90_COUNTERCLOCKWISE.
    reoriented = np.rot90(occ_grid[::-1, :], 1)

    pose = np.asarray(pose, dtype=np.float64)
    quat = euler_xyz_to_quaternion(pose[3:])
    rmat = quaternion_to_matrix(quat)
    first_cell_bev = np.array([0.0, -map_width / 2.0, 0.0]) + pose[:3]
    origin = rmat @ first_cell_bev

    return OccupancyGridMessage(
        data=np.ascontiguousarray(reoriented).reshape(-1),
        # Reference swaps: msg height from metric width and vice versa
        # (occgrid_to_ros.py:39-41), consistent with the rotation above.
        height=int(map_width / map_resolution),
        width=int(map_height / map_resolution),
        resolution=float(map_resolution),
        origin_position=origin,
        origin_orientation=quat,
        frame_id=frame_id,
        stamp=time_stamp,
    )


# Alias mirroring the reference function name (occgrid_to_ros.py:13).
convert_to_occupancy_grid_msg = to_occupancy_grid_msg


def to_rospy_msg(msg: OccupancyGridMessage):
    """Convert to a real ``nav_msgs/OccupancyGrid`` (requires rospy).

    Kept at the very edge so the framework core stays ROS-free
    (SURVEY.md §2b: ROS TCPROS is an external transport, not compute).
    """
    import rospy
    from nav_msgs.msg import MapMetaData, OccupancyGrid
    from geometry_msgs.msg import Point, Pose, Quaternion
    from std_msgs.msg import Header

    out = OccupancyGrid()
    out.header = Header()
    out.header.frame_id = msg.frame_id
    if msg.stamp is not None:
        out.header.stamp = rospy.Time.from_sec(msg.stamp)

    out.info = MapMetaData()
    out.info.width = msg.width
    out.info.height = msg.height
    out.info.resolution = msg.resolution
    out.info.origin = Pose()
    out.info.origin.position = Point(*msg.origin_position)
    out.info.origin.orientation = Quaternion(*msg.origin_orientation)
    out.info.map_load_time = rospy.Time.now()
    out.data = msg.data.tolist()
    return out


class GridPublisher:
    """Minimal publisher: pipeline grids → ROS topic (rospy optional).

    Replaces the publisher half of the missing ``inference_video.py``
    (SURVEY.md §3.1).  Without rospy it degrades to collecting messages on
    ``.last_message`` so the loop stays testable off-robot.
    """

    def __init__(self, topic: str = "/occupancy_grid", queue_size: int = 1):
        self.topic = topic
        self.last_message: Optional[OccupancyGridMessage] = None
        try:
            import rospy
            from nav_msgs.msg import OccupancyGrid
            self._pub = rospy.Publisher(topic, OccupancyGrid,
                                        queue_size=queue_size)
        except Exception:
            self._pub = None

    def publish(self, msg: OccupancyGridMessage) -> None:
        self.last_message = msg
        if self._pub is not None:
            self._pub.publish(to_rospy_msg(msg))


__all__ = [
    "OccupancyGridMessage", "to_occupancy_grid_msg",
    "convert_to_occupancy_grid_msg", "to_rospy_msg", "GridPublisher",
    "euler_xyz_to_quaternion", "quaternion_to_matrix", "euler_xyz_to_matrix",
]
