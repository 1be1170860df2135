"""The reference's pre-pass: a frozen copy of the port's software
depth/normal rasterizer (``ops/raster.py``), run by the reference on the
benchmark's own scene arrays.  Depth is the world distance to the camera
(DepthPrePass.shader:41-48), the normal the perspective-correct
interpolation of the corner normals, renormalized
(NormalPrePass.shader:35-38); background texels hold 0.  Pixel
(px, py) covers [px, px+1) x [py, py+1), py = 0 the bottom row.

The result is kept by content under the reference's own cache directory
(``bake``): the host rasterization of DragonScene at 1920 x 1080 takes
about a minute.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from portbench.scene import projection_matrix, view_matrix


def bake(triangles: np.ndarray, cam: dict, corner_normals: np.ndarray,
         cache_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """(depth f32[H, W], normal f32[H, W, 3]), from ``cache_dir`` when a
    bake of the same arrays and camera is there."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(triangles, dtype=np.float32).tobytes())
    h.update(np.ascontiguousarray(corner_normals, dtype=np.float32).tobytes())
    h.update(repr(sorted(cam.items())).encode())
    path = os.path.join(cache_dir, f"{h.hexdigest()}.npz")
    try:
        with np.load(path) as z:
            return z["depth"], z["normal"]
    except (OSError, KeyError, ValueError):
        pass
    depth, normal = rasterize_depth_normal(triangles, cam, corner_normals)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, depth=depth, normal=normal)
    os.replace(tmp, path)
    return depth, normal


def rasterize_depth_normal(
    triangles: np.ndarray, cam: dict, corner_normals: np.ndarray = None
) -> tuple[np.ndarray, np.ndarray]:
    """triangles: f32[T, 3, 3] world soup -> (depth f32[H, W], normal f32[H, W, 3]).

    ``corner_normals``: optional f32[T, 3, 3] world-space shading normals
    (see module docstring).

    Triangles with any vertex at or behind the near plane are culled (no
    clipping); for the benchmark cameras the colliders are fully in front.
    """
    h_px, w_px = cam["height"], cam["width"]
    depth = np.zeros((h_px, w_px), dtype=np.float32)
    normal = np.zeros((h_px, w_px, 3), dtype=np.float32)
    # z-buffer on camera distance; background = +inf until final fixup
    zbuf = np.full((h_px, w_px), np.inf, dtype=np.float32)

    tris = np.asarray(triangles, dtype=np.float64)
    if len(tris) == 0:
        return depth, normal

    vp = projection_matrix(cam) @ view_matrix(cam)
    cam_pos = np.asarray(cam["position"], dtype=np.float64)

    verts = tris.reshape(-1, 3)
    clip_w = verts @ vp[3, :3].T + vp[3, 3]
    hom = verts @ vp[:3, :3].T + vp[:3, 3]
    w3 = clip_w.reshape(-1, 3)
    # cull triangles not fully in front of the near plane
    ok = (w3 > 1e-6).all(axis=1)

    ndc = hom / clip_w[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * w_px
    sy = (ndc[:, 1] * 0.5 + 0.5) * h_px
    sx3 = sx.reshape(-1, 3)
    sy3 = sy.reshape(-1, 3)
    inv_w3 = (1.0 / clip_w).reshape(-1, 3)
    world3 = verts.reshape(-1, 3, 3)

    # screen-space bbox cull
    lo_x = np.floor(sx3.min(axis=1)).astype(np.int64)
    hi_x = np.ceil(sx3.max(axis=1)).astype(np.int64)
    lo_y = np.floor(sy3.min(axis=1)).astype(np.int64)
    hi_y = np.ceil(sy3.max(axis=1)).astype(np.int64)
    ok &= (hi_x >= 0) & (lo_x < w_px) & (hi_y >= 0) & (lo_y < h_px)

    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    face_n = np.cross(e1, e2)
    n_len = np.linalg.norm(face_n, axis=1, keepdims=True)
    ok &= n_len[:, 0] > 1e-20
    face_n = face_n / np.maximum(n_len, 1e-300)
    if corner_normals is not None:
        cnorm3 = np.asarray(corner_normals, dtype=np.float64)

    idxs = np.where(ok)[0]
    lo_x = np.clip(lo_x, 0, w_px - 1)
    hi_x = np.clip(hi_x, 0, w_px)
    lo_y = np.clip(lo_y, 0, h_px - 1)
    hi_y = np.clip(hi_y, 0, h_px)

    for ti in idxs:
        x0, x1 = lo_x[ti], hi_x[ti]
        y0, y1 = lo_y[ti], hi_y[ti]
        if x1 <= x0 or y1 <= y0:
            continue
        ax, ay = sx3[ti, 0], sy3[ti, 0]
        bx, by = sx3[ti, 1], sy3[ti, 1]
        cx, cy = sx3[ti, 2], sy3[ti, 2]
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        if area == 0.0:
            continue
        # pixel centers
        pxs = np.arange(x0, x1) + 0.5
        pys = np.arange(y0, y1) + 0.5
        gx, gy = np.meshgrid(pxs, pys)
        w0 = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
        w1 = (cx - bx) * (gy - by) - (cy - by) * (gx - bx)
        w2 = (ax - cx) * (gy - cy) - (ay - cy) * (gx - cx)
        if area > 0:
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        else:
            inside = (w0 <= 0) & (w1 <= 0) & (w2 <= 0)
        if not inside.any():
            continue
        # barycentric (w1 weights vertex 0, w2 -> 1, w0 -> 2 by edge order)
        b0 = w1 / area
        b1 = w2 / area
        b2 = w0 / area
        inv_w = (
            b0 * inv_w3[ti, 0] + b1 * inv_w3[ti, 1] + b2 * inv_w3[ti, 2]
        )
        wp = (
            b0[..., None] * (world3[ti, 0] * inv_w3[ti, 0])
            + b1[..., None] * (world3[ti, 1] * inv_w3[ti, 1])
            + b2[..., None] * (world3[ti, 2] * inv_w3[ti, 2])
        ) / inv_w[..., None]
        dist = np.linalg.norm(wp - cam_pos, axis=-1)

        sub_z = zbuf[y0:y1, x0:x1]
        upd = inside & (dist < sub_z)
        if not upd.any():
            continue
        sub_z[upd] = dist[upd]
        zbuf[y0:y1, x0:x1] = sub_z
        sub_d = depth[y0:y1, x0:x1]
        sub_d[upd] = dist[upd]
        depth[y0:y1, x0:x1] = sub_d
        sub_n = normal[y0:y1, x0:x1]
        if corner_normals is None:
            sub_n[upd] = face_n[ti]
        else:
            nrm = (
                b0[..., None] * (cnorm3[ti, 0] * inv_w3[ti, 0])
                + b1[..., None] * (cnorm3[ti, 1] * inv_w3[ti, 1])
                + b2[..., None] * (cnorm3[ti, 2] * inv_w3[ti, 2])
            ) / inv_w[..., None]
            nrm /= np.maximum(
                np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-300
            )
            sub_n[upd] = nrm[upd]
        normal[y0:y1, x0:x1] = sub_n

    return depth, normal
