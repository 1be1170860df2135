"""Cameras with Unity-compatible view/projection conventions.

The screen-space collision kernel consumes ``viewMat`` (worldToCameraMatrix)
and ``projectionMat`` exactly as Unity supplies them (ParticleSys.cs:596-597)
and maps NDC to pixels via ``screen = (ndc*0.5+0.5) * screenSize``
(ScreenSpaceDepthCollisionDetection.compute:43-53).  We reproduce those
matrices: Unity's camera space is right-handed (view looks down -Z, i.e. the
world is Z-negated after the rigid transform), and the projection is the
GL-style frustum with vertical field of view.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from particlesystemhybridcollisiondetection_tpu_torch.geometry.mesh import Transform


@dataclasses.dataclass(frozen=True)
class Camera:
    """A benchmark camera (scene YAML: fov 45, near 0.3, far 4096)."""

    transform: Transform
    fov_deg: float = 45.0
    near: float = 0.3
    far: float = 4096.0
    width: int = 1920
    height: int = 1080
    name: str = "camera"

    @property
    def position(self) -> np.ndarray:
        return np.asarray(self.transform.position, dtype=np.float64)

    @property
    def forward(self) -> np.ndarray:
        return self.transform.forward()

    def view_matrix(self) -> np.ndarray:
        """Unity worldToCameraMatrix: flip-Z * R^T * T(-pos)."""
        m = self.transform.matrix()
        r = m[:3, :3]  # rotation (camera transforms have unit scale)
        view = np.eye(4)
        view[:3, :3] = r.T
        view[:3, 3] = -r.T @ self.position
        view[2, :] *= -1.0  # Unity camera space looks down -Z
        return view

    def projection_matrix(self) -> np.ndarray:
        """GL-style perspective projection (Unity Camera.projectionMatrix)."""
        f = 1.0 / np.tan(np.deg2rad(self.fov_deg) / 2.0)
        aspect = self.width / self.height
        n, fa = self.near, self.far
        p = np.zeros((4, 4))
        p[0, 0] = f / aspect
        p[1, 1] = f
        p[2, 2] = -(fa + n) / (fa - n)
        p[2, 3] = -2.0 * fa * n / (fa - n)
        p[3, 2] = -1.0
        return p

    def view_proj(self) -> np.ndarray:
        return self.projection_matrix() @ self.view_matrix()


def project_to_screen(points: np.ndarray, cam: Camera) -> tuple[np.ndarray, np.ndarray]:
    """Host-side projection for the rasterizer.

    points: f64[..., 3] world positions.
    Returns (screen_xy in pixels f64[..., 2], clip_w f64[...]) using the
    same NDC->pixel mapping as the collision kernel.
    """
    vp = cam.view_proj()
    hom = points @ vp[:3, :3].T + vp[:3, 3]
    w = points @ vp[3, :3].T + vp[3, 3]
    ndc = hom / w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * cam.width
    sy = (ndc[..., 1] * 0.5 + 0.5) * cam.height
    return np.stack([sx, sy], axis=-1), w
