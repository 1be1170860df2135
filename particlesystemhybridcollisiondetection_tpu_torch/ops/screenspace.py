"""Screen-space depth collision detection.

Port of the JAX package's ``ops/screenspace.py``
(ScreenSpaceDepthCollisionDetection.compute:31-76 and its hybrid variant
:87-143): project each particle through the camera, gather depth (=
camera distance) and world normal from the pre-pass textures, and
collide iff ``|eyeDist - depth| <= radius`` and the velocity points into
the surface.  The hybrid variant also returns the "undecided" set --
particles off-screen, behind the camera, or occluded (``eyeDist >
depth``) -- as a boolean mask that gates the exact second stage; no
atomics, no host read.

``screen_space_collide`` runs its plain PyTorch version
(``screen_space_collide_plain``, on ``[3, N]`` planar tensors) for tensors
on the CPU, and for CUDA tensors launches the hand-written kernel
(``ops/cuda/screenspace_kernel.py``; the JAX package runs this stage in
XLA, not in a Pallas kernel) or raises.  ``screen_space_collide_rows`` is
the hybrid's pass in place on a runner's carried rows.  The projection is
written out component by component, so every lane rounds the same way
whatever its position in the particle axis, and the kernel (built without
fused multiply-add) rounds as the plain version does.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.core import vec
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    resolve_device,
)
from particlesystemhybridcollisiondetection_tpu_torch.geometry.camera import Camera
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
    screenspace_kernel as ssk,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.raster import (
    rasterize_depth_normal,
)


class CameraTextures(NamedTuple):
    """Camera constants + pre-pass textures, on the step's device.

    Mirrors the uniforms bound at ParticleSys.cs:596-606 plus the
    depth/normal RenderTextures.
    """

    view: torch.Tensor  # f32[4, 4] worldToCameraMatrix
    proj: torch.Tensor  # f32[4, 4] projectionMatrix
    cam_pos: torch.Tensor  # f32[3]
    cam_fwd: torch.Tensor  # f32[3]
    depth: torch.Tensor  # f32[H, W] camera-distance depth
    normal: torch.Tensor  # f32[H, W, 3] world normals
    # depth + normal as ONE planar [4, H*W] table (row 0 depth, rows 1-3
    # normal xyz): one column gather per particle reads all four
    planar: torch.Tensor  # f32[4, H*W]
    # the same table interleaved, a texel's four values side by side: the
    # kernel's one 16 B load a lane (the plain version reads ``planar``)
    texels: torch.Tensor  # f32[H*W, 4]

    @property
    def screen_size(self) -> tuple[int, int]:
        return tuple(self.depth.shape)  # (H, W)


_BAKE_CACHE: dict = {}


def _bake_disk_dir() -> str:
    """Directory of the content-keyed bake cache: ``PSYS_BAKE_CACHE``,
    else ``~/.cache/psys_bake`` (the JAX package's variable and default,
    so the two packages share bakes: same key, same arrays)."""
    return os.environ.get(
        "PSYS_BAKE_CACHE", os.path.expanduser("~/.cache/psys_bake"))


def _disk_key(tris: np.ndarray, corner_normals, cam: Camera) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(tris, dtype=np.float32).tobytes())
    if corner_normals is not None:
        h.update(
            np.ascontiguousarray(corner_normals, dtype=np.float32).tobytes()
        )
    h.update(
        repr(
            (
                cam.name,
                cam.width,
                cam.height,
                np.asarray(cam.position).tolist(),
                np.asarray(cam.view_matrix()).tolist(),
                np.asarray(cam.projection_matrix()).tolist(),
            )
        ).encode()
    )
    return h.hexdigest()


def bake_path(triangles: np.ndarray, cam: Camera, corner_normals=None) -> str:
    """The ``.npz`` file that holds (or will hold) this bake."""
    key = _disk_key(np.asarray(triangles), corner_normals, cam)
    return os.path.join(_bake_disk_dir(), f"{key}.npz")


def bake_camera(
    triangles: np.ndarray, cam: Camera, corner_normals: np.ndarray = None,
    *, device="cuda",
) -> CameraTextures:
    """One-time pre-pass for a static scene + camera (the analog of
    DepthPrePass/NormalPrePass, run per frame in the reference but
    invariant here), rasterized on the host.  ``corner_normals`` enables
    the reference's smooth vertex-normal interpolation
    (NormalPrePass.shader:35-38).

    Memoized in the process on (scene arrays' identity, camera, device),
    and on disk by content (``bake_path``): the host rasterization of a
    benchmark scene at 1080p takes about a minute.
    """
    dev = resolve_device(device)
    tris = np.asarray(triangles)
    key = (
        # id() alone can be reused after GC; shape + content checksum
        # guards against stale hits
        id(triangles),
        tris.shape,
        float(tris.sum()) if tris.size else 0.0,
        None if corner_normals is None else id(corner_normals),
        cam.name,
        cam.width,
        cam.height,
        tuple(np.asarray(cam.position).tolist()),
        tuple(tuple(r) for r in np.asarray(cam.view_matrix()).tolist()),
        str(dev),
    )
    hit = _BAKE_CACHE.get(key)
    if hit is not None:
        return hit

    dpath = bake_path(tris, cam, corner_normals)
    depth = normal = None
    try:
        with np.load(dpath) as z:
            depth, normal = z["depth"], z["normal"]
    except (OSError, KeyError, ValueError):
        pass
    if depth is None:
        depth, normal = rasterize_depth_normal(triangles, cam, corner_normals)
        try:
            os.makedirs(os.path.dirname(dpath), exist_ok=True)
            tmp = f"{dpath}.{os.getpid()}.tmp.npz"  # savez wants .npz
            np.savez(tmp, depth=depth, normal=normal)
            os.replace(tmp, dpath)  # atomic vs concurrent bakers
        except OSError:
            pass
    planar = np.concatenate(
        [
            np.asarray(depth).reshape(1, -1),
            np.asarray(normal).reshape(-1, 3).T,
        ],
        axis=0,
    ).astype(np.float32)  # [4, H*W]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    tex = CameraTextures(
        view=t(cam.view_matrix()),
        proj=t(cam.projection_matrix()),
        cam_pos=t(cam.position),
        cam_fwd=t(cam.forward),
        depth=t(depth),
        normal=t(normal),
        planar=t(planar),
        texels=t(planar.T),
    )
    _BAKE_CACHE[key] = tex
    return tex


def _transform(m: torch.Tensor, xyz: torch.Tensor, w) -> torch.Tensor:
    """``m @ [xyz; w]`` for f32[4, 4] ``m``, row by row as
    ``((m0 x + m1 y) + m2 z) + m3 w``."""
    return torch.stack([
        m[r, 0] * xyz[0] + m[r, 1] * xyz[1] + m[r, 2] * xyz[2] + m[r, 3] * w
        for r in range(4)
    ])


def _pixel_index(sx: torch.Tensor, sy: torch.Tensor, h_px: int, w_px: int):
    """Flat texel index of screen coordinates in [0, 1]: truncated, then
    clamped into the texture (after the cast, so a NaN or an infinite
    coordinate still gives an index inside the table)."""
    px = torch.clamp((sx * w_px).to(torch.int32), 0, w_px - 1)
    py = torch.clamp((sy * h_px).to(torch.int32), 0, h_px - 1)
    return (py * w_px + px).long()


def screen_space_collide(
    state: ParticleState,
    tex: CameraTextures,
    gravity: torch.Tensor,
    dt: float,
    *,
    hybrid: bool = False,
) -> tuple[ParticleState, torch.Tensor]:
    """One collision pass.  Returns (new_state, undecided bool[N]).

    ``undecided`` is all-False unless ``hybrid``.  CPU tensors take the
    plain version; CUDA tensors one launch of the kernel.
    """
    if state.pos.device.type == "cpu":
        return screen_space_collide_plain(state, tex, gravity, dt, hybrid=hybrid)
    pos, vel, coll, undecided = ssk.screen_space_collide(
        state.pos, state.vel, state.collisions, state.radius, state.restitution, tex,
        gravity, dt, hybrid=hybrid)
    if undecided is None:
        undecided = torch.zeros_like(coll, dtype=torch.bool)
    return state._replace(pos=pos, vel=vel, collisions=coll), undecided


def screen_space_collide_rows(rows8: torch.Tensor, collisions: torch.Tensor,
                              undecided: torch.Tensor, tex: CameraTextures,
                              gravity: torch.Tensor, dt: float) -> None:
    """The hybrid's pass in place on a runner's carried rows: f32[8, N]
    ``rows8`` (pos 0-2, vel 3-5, radius 6, restitution 7) and i32[N]
    ``collisions`` take the pass's result, bool[N] ``undecided`` its
    mask.  On the CPU through the plain version; on CUDA one launch that
    writes pos, vel and the count only where a lane collides."""
    if rows8.device.type != "cpu":
        return ssk.screen_space_collide_rows(rows8, collisions, undecided, tex,
                                             gravity, dt)
    st, und = screen_space_collide_plain(
        ParticleState(pos=rows8[0:3], vel=rows8[3:6], collisions=collisions,
                      radius=rows8[6], restitution=rows8[7]),
        tex, gravity, dt, hybrid=True)
    rows8[0:3].copy_(st.pos)
    rows8[3:6].copy_(st.vel)
    collisions.copy_(st.collisions)
    undecided.copy_(und)


def screen_space_collide_plain(
    state: ParticleState,
    tex: CameraTextures,
    gravity: torch.Tensor,
    dt: float,
    *,
    hybrid: bool = False,
) -> tuple[ParticleState, torch.Tensor]:
    """Plain version of ``screen_space_collide``: the kernel's oracle."""
    pos, velo = state.pos, state.vel
    h_px, w_px = tex.screen_size

    speed2 = vec.dot(velo, velo)
    moving = speed2 != 0.0  # compute:33 early-out

    # projection (compute:39-47)
    view_pos = _transform(tex.view, pos, 1.0)  # [4, N]
    clip = _transform(tex.proj, view_pos[:3], view_pos[3])
    ndc = clip[:3] / clip[3]
    sx = ndc[0] * 0.5 + 0.5
    sy = ndc[1] * 0.5 + 0.5

    inside = (sx >= 0.0) & (sx <= 1.0) & (sy >= 0.0) & (sy <= 1.0)
    to_particle = pos - tex.cam_pos[:, None]
    in_front = vec.dot(tex.cam_fwd[:, None], to_particle) > 0.0
    visible = inside & in_front

    # texture gather at truncated pixel coords (compute:53-59).  HLSL
    # Load() out of bounds returns 0; clamping to the last texel only
    # differs on the measure-zero sx == 1.0 boundary.  The clamp comes
    # after the integer cast, so lanes far off screen (padding at 1e38,
    # whose NDC may be NaN) still index inside the table; only visible
    # lanes use what they gather.
    g = tex.planar[:, _pixel_index(sx, sy, h_px, w_px)]  # [4, N]
    depth = g[0]
    normal = g[1:4]  # [3, N]

    eye_dist = vec.norm(to_particle)
    diff = torch.abs(eye_dist - depth)
    into = vec.dot(normal, velo) < 0.0

    near_surface = diff <= state.radius
    collide = moving & visible & near_surface & into

    # response (compute:65-69): vel' first, then pos += (vel' - vel)*dt
    dirn = vec.normalize(velo)
    refl = vec.normalize(vec.reflect(dirn, normal))
    speed = torch.sqrt(speed2)
    new_vel = refl * (state.restitution * speed)[None] - gravity[:, None] * dt
    new_pos = pos + new_vel * dt - velo * dt

    out = state._replace(
        pos=vec.where(collide, new_pos, pos),
        vel=vec.where(collide, new_vel, velo),
        collisions=state.collisions + collide.to(torch.int32),
    )

    if hybrid:
        # compute:105-142: undecided = off-screen/behind-camera, or
        # occluded beyond the depth surface
        occluded = visible & ~near_surface & (eye_dist > depth)
        undecided = moving & (~visible | occluded)
    else:
        undecided = torch.zeros_like(moving)
    return out, undecided
