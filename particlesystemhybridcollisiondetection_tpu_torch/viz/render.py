"""Offline particle/scene renderer (port of the JAX package's
``viz/render.py``; host NumPy, the same pixels).

Rendering in the reference is GPU-instanced unit spheres scaled by the
particle radius, positions pulled straight from the particle buffer
(InstancedParticleSpheres.shader:82-98, draw at ParticleSys.cs:492).
Here rendering is off the hot path: positions come back to the host and
are rasterized into PNGs -- scene via the depth/normal pre-pass
rasterizer (lambert-shaded), particles as depth-tested disks.

Used by the accuracy-visualization harness (ACCURACY_VISUALIZATION mode,
ParticleSys.cs:763-830) and the grid-occupancy debug views (the analog of
the BVH node visualization, ParticleSys.cs:1310-1427).
"""

from __future__ import annotations

import numpy as np

from particlesystemhybridcollisiondetection_tpu_torch.geometry.camera import Camera
from particlesystemhybridcollisiondetection_tpu_torch.ops.raster import (
    rasterize_depth_normal,
)

LIGHT_DIR = np.array([0.4, 0.8, -0.45])
LIGHT_DIR = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)


def shade_scene(
    triangles: np.ndarray,
    cam: Camera,
    background=(26, 28, 33),
    albedo=(170, 170, 175),
) -> tuple[np.ndarray, np.ndarray]:
    """Lambert-shaded scene image + its depth buffer.

    Returns (rgb uint8[H, W, 3] with row 0 = top, depth f32[H, W] in the
    rasterizer's bottom-up row order).
    """
    depth, normal = rasterize_depth_normal(triangles, cam)
    lam = np.clip(normal @ LIGHT_DIR, 0.0, 1.0) * 0.85 + 0.15
    covered = depth > 0
    img = np.empty(depth.shape + (3,), dtype=np.float64)
    img[:] = background
    img[covered] = np.asarray(albedo) * lam[covered, None]
    # rasterizer rows are bottom-up (NDC y); images are top-down
    return img[::-1].astype(np.uint8), depth


def splat_particles(
    img: np.ndarray,
    depth: np.ndarray,
    positions: np.ndarray,
    radius,
    cam: Camera,
    colors=None,
) -> np.ndarray:
    """Draw particles as depth-tested disks onto a shaded scene image.

    positions: [N, 3] world (or [3, N] planar); radius scalar or [N];
    colors: [N, 3] uint8 (default: speed-independent orange).
    """
    if positions.shape[0] == 3 and positions.ndim == 2 and positions.shape[1] != 3:
        positions = positions.T
    n = len(positions)
    radius = np.broadcast_to(np.asarray(radius, dtype=np.float64), (n,))
    if colors is None:
        colors = np.broadcast_to(
            np.array([235, 140, 50], dtype=np.uint8), (n, 3)
        )

    h_px, w_px = depth.shape
    vp = cam.view_proj()
    hom = positions @ vp[:3, :3].T + vp[:3, 3]
    w = positions @ vp[3, :3].T + vp[3, 3]
    ok = w > 1e-6
    ndc = hom / np.where(ok, w, 1.0)[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * w_px
    sy = (ndc[:, 1] * 0.5 + 0.5) * h_px
    dist = np.linalg.norm(positions - cam.position, axis=-1)
    # screen-space radius: project a sphere of radius r at this depth
    f = h_px / (2.0 * np.tan(np.deg2rad(cam.fov_deg) / 2.0))
    pr = np.maximum(radius * f / np.maximum(dist, 1e-6), 0.6)
    ok &= (sx > -50) & (sx < w_px + 50) & (sy > -50) & (sy < h_px + 50)

    zbuf = np.where(depth > 0, depth, np.inf)
    order = np.argsort(-dist)  # far to near
    out = img[::-1].copy()  # back to bottom-up rows to match depth
    for i in order:
        if not ok[i]:
            continue
        r_px = pr[i]
        x0 = max(int(sx[i] - r_px), 0)
        x1 = min(int(sx[i] + r_px) + 1, w_px)
        y0 = max(int(sy[i] - r_px), 0)
        y1 = min(int(sy[i] + r_px) + 1, h_px)
        if x1 <= x0 or y1 <= y0:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5)
        d2 = (gx - sx[i]) ** 2 + (gy - sy[i]) ** 2
        inside = d2 <= r_px * r_px
        visible = inside & (dist[i] <= zbuf[y0:y1, x0:x1] + radius[i])
        if not visible.any():
            continue
        # cheap sphere shading: brighten towards the light-facing rim
        t = np.sqrt(np.maximum(1.0 - d2 / (r_px * r_px), 0.0))
        shade = (0.35 + 0.65 * t)[..., None]
        region = out[y0:y1, x0:x1]
        region[visible] = (colors[i] * shade[visible]).astype(np.uint8)
        zb = zbuf[y0:y1, x0:x1]
        zb[visible] = dist[i]
        zbuf[y0:y1, x0:x1] = zb
    return out[::-1]


def render_state(
    triangles: np.ndarray,
    positions: np.ndarray,
    radius,
    cam: Camera,
    colors=None,
) -> np.ndarray:
    """Full frame: shaded scene + particles.  Returns uint8[H, W, 3]."""
    img, depth = shade_scene(triangles, cam)
    return splat_particles(img, depth, positions, radius, cam, colors)


def collision_colormap(counts: np.ndarray) -> np.ndarray:
    """Per-particle colors from collision counters (accuracy viz): blue
    (0) -> orange -> red (many)."""
    c = np.asarray(counts, dtype=np.float64)
    t = np.clip(c / max(c.max(), 1.0), 0.0, 1.0)
    rgb = np.stack(
        [60 + 195 * t, 90 + 80 * (1 - np.abs(t - 0.5) * 2), 200 * (1 - t)],
        axis=-1,
    )
    return rgb.astype(np.uint8)
