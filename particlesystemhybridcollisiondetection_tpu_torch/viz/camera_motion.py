"""Camera motion for offline rendering (the free-camera analog; port of
the JAX package's ``viz/camera_motion.py``).

The reference's CameraMovement.cs is a mouse-look + WASD fly camera for
interactive inspection (Assets/Scripts/CameraMovement.cs:7-59).  Offline
rendering has no input loop, so the equivalent is parametric camera paths:
orbits and waypoint fly-throughs that generate per-frame Camera objects
for turntable/animation renders.
"""

from __future__ import annotations

import numpy as np

from particlesystemhybridcollisiondetection_tpu_torch.geometry.camera import Camera
from particlesystemhybridcollisiondetection_tpu_torch.geometry.mesh import Transform


def look_at(position, target, width=1920, height=1080, name="camera") -> Camera:
    """Camera at ``position`` looking at ``target`` (Y-up)."""
    position = np.asarray(position, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    fwd = target - position
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-9:  # looking straight up/down
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    up2 = np.cross(fwd, right)
    # rotation matrix with columns (right, up, fwd) -> quaternion
    m = np.stack([right, up2, fwd], axis=1)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    else:
        i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        qw = (m[k, j] - m[j, k]) / s
        qx, qy, qz = q
    return Camera(
        Transform(position=tuple(position), rotation=(qx, qy, qz, qw)),
        width=width,
        height=height,
        name=name,
    )


def orbit_path(
    center,
    radius: float,
    height: float,
    frames: int,
    width: int = 1920,
    height_px: int = 1080,
) -> list[Camera]:
    """Turntable orbit around ``center``."""
    center = np.asarray(center, dtype=np.float64)
    cams = []
    for i in range(frames):
        a = 2.0 * np.pi * i / frames
        pos = center + np.array([radius * np.cos(a), height, radius * np.sin(a)])
        cams.append(
            look_at(pos, center, width, height_px, name=f"orbit_{i:04d}")
        )
    return cams


def fly_path(
    waypoints,
    targets,
    frames: int,
    width: int = 1920,
    height_px: int = 1080,
) -> list[Camera]:
    """Piecewise-linear fly-through: interpolate positions and look
    targets through the given waypoints (the WASD-path analog)."""
    wp = np.asarray(waypoints, dtype=np.float64)
    tg = np.asarray(targets, dtype=np.float64)
    t = np.linspace(0.0, len(wp) - 1.0, frames)
    i0 = np.clip(t.astype(int), 0, len(wp) - 2)
    f = (t - i0)[:, None]
    pos = wp[i0] * (1 - f) + wp[i0 + 1] * f
    tgt = tg[np.clip(i0, 0, len(tg) - 2)] * (1 - f) + tg[
        np.clip(i0 + 1, 0, len(tg) - 1)
    ] * f
    return [
        look_at(pos[i], tgt[i], width, height_px, name=f"fly_{i:04d}")
        for i in range(frames)
    ]
