"""The benchmark's scene inputs, frozen: DragonScene as data.

A NumPy copy of the port's ``geometry/scenes.py::dragon_scene`` (the
ground plane and the procedural 397,688-triangle stand-in for
``dragon.fbx``), its mesh helpers and the four benchmark cameras, kept
here so that the benchmark makes its inputs itself and later changes to
the program cannot move them.  ``portbench/tests`` holds every array to
the program's bit for bit.  The face list of ``cube_sphere`` is built
without a Python loop, in the same order.

A scene is a dict: ``name``, ``triangles`` f32[T, 3, 3] (world soup),
``corner_normals`` f32[T, 3, 3] and ``cameras`` {name: camera dict}.  A
camera dict holds the Unity transform (``position``, ``rotation`` as a
quaternion xyzw), ``fov_deg``, ``near``, ``far``, ``width``, ``height``
and ``name``; ``view_matrix`` / ``projection_matrix`` / ``forward``
compute from it what the pre-pass and the screen-space stage read.
"""

from __future__ import annotations

import numpy as np

# DragonScene.unity / BenchmarkManager.cs: the four benchmark cameras
CAMERAS = (
    ("Main Camera", (0.0, 470.6, -678.7), (0.17364816, 0.0, 0.0, 0.9848078)),
    ("Main Camera (1)", (-626.7, 230.0, -486.7), (0.0, 0.42261827, 0.0, 0.9063079)),
    ("Main Camera (2)", (0.0, 800.0, 50.0), (0.7071068, 0.0, 0.0, 0.7071068)),
    ("Main Camera (3)", (0.0, 16.3, 364.0), (0.0, 0.949133, 0.31487557, 0.0)),
)


def trs_matrix(position, rotation, scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Unity TRS as a 4x4 local->world matrix (column vectors)."""
    x, y, z, w = rotation
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    rot = np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
            [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
            [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
        ]
    )
    m = np.eye(4)
    m[:3, :3] = rot @ np.diag(scale)
    m[:3, 3] = position
    return m


def unity_plane(segments: int = 10):
    """Unity's built-in Plane: 10 x 10 units in XZ, +Y up; (verts, faces)."""
    n = segments + 1
    xs = np.linspace(5.0, -5.0, n)
    zs = np.linspace(5.0, -5.0, n)
    gx, gz = np.meshgrid(xs, zs, indexing="xy")
    verts = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
    faces = []
    for r in range(segments):
        for c in range(segments):
            a = r * n + c
            b = a + 1
            cc = a + n
            d = cc + 1
            faces.append([a, cc, b])
            faces.append([b, cc, d])
    return verts, np.asarray(faces, dtype=np.int64)


def cube_sphere(n: int):
    """Quad-sphere: 6 cube faces of n x n quads projected to the unit
    sphere; (verts, faces)."""
    verts, faces = [], []
    axes = [
        (0, 1, 2, +1.0), (0, 1, 2, -1.0),
        (1, 2, 0, +1.0), (1, 2, 0, -1.0),
        (2, 0, 1, +1.0), (2, 0, 1, -1.0),
    ]
    offset = 0
    i, j = np.meshgrid(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64),
                       indexing="ij")
    for (a, b, c, s) in axes:
        lin = np.linspace(-1.0, 1.0, n + 1)
        uu, vv = np.meshgrid(lin, lin, indexing="ij")
        p = np.zeros(uu.shape + (3,))
        p[..., a] = uu
        p[..., b] = vv
        p[..., c] = s
        p = p / np.linalg.norm(p, axis=-1, keepdims=True)
        verts.append(p.reshape(-1, 3))
        q = offset + i * (n + 1) + j
        quad = np.stack([np.stack([q, q + 1, q + n + 1], -1),
                         np.stack([q + 1, q + n + 2, q + n + 1], -1)], -2)
        faces.append(quad.reshape(-1, 3))
        offset += (n + 1) * (n + 1)
    return np.concatenate(verts), np.concatenate(faces)


def smooth_corner_normals(verts, faces) -> np.ndarray:
    """Area-weighted smooth vertex normals, per corner f64[T, 3, 3]."""
    tris = verts[faces]
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-300)
    return vn[faces]


def dragon_standin(tri_budget: int):
    """The procedural stand-in for dragon.fbx: a ridged, displaced
    cube-sphere at the dragon's footprint, smooth normals;
    (verts, faces, corner normals)."""
    n = max(16, int(np.sqrt(tri_budget / 12.0)))
    v, faces = cube_sphere(n)
    v = v.copy()
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    disp = (
        0.18 * np.sin(1.7 * d[:, 0:1] * np.pi + 1.0) * np.sin(1.3 * d[:, 2:3] * np.pi)
        + 0.10 * np.sin(2.9 * d[:, 1:2] * np.pi) * np.cos(2.1 * d[:, 0:1] * np.pi)
        + 0.05 * np.cos(4.1 * d[:, 2:3] * np.pi + 0.5) * np.sin(3.3 * d[:, 1:2] * np.pi)
    )
    v = v * (1.0 + disp)
    v[:, 0] *= 1.6
    v[:, 2] *= 0.9
    vmin, vmax = v.min(0), v.max(0)
    target = np.array([500.0, 400.0, 320.0])
    v = (v - (vmin + vmax) / 2) / (vmax - vmin) * target
    v[:, 1] -= v[:, 1].min()
    return v, faces, smooth_corner_normals(v, faces)


def _world(verts, faces, corner_normals, m):
    """(triangles, corner normals) of one instance in world space, f64."""
    tris = verts[faces] @ m[:3, :3].T + m[:3, 3]
    if corner_normals is None:
        t = verts[faces]
        fn = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        corner_normals = np.broadcast_to(fn[:, None, :], t.shape)
    wn = corner_normals @ np.linalg.inv(m[:3, :3])
    wn = wn / np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-300)
    return tris, wn


def camera(name: str, width: int, height: int) -> dict:
    """One of the four benchmark cameras (fov 45, near 0.3, far 4096)."""
    for cname, pos, rot in CAMERAS:
        if cname == name:
            return {"name": cname, "position": pos, "rotation": rot,
                    "fov_deg": 45.0, "near": 0.3, "far": 4096.0,
                    "width": width, "height": height}
    raise KeyError(f"no camera named {name!r}")


def view_matrix(cam: dict) -> np.ndarray:
    """Unity worldToCameraMatrix: flip-Z * R^T * T(-pos)."""
    m = trs_matrix(cam["position"], cam["rotation"])
    r = m[:3, :3]
    pos = np.asarray(cam["position"], dtype=np.float64)
    view = np.eye(4)
    view[:3, :3] = r.T
    view[:3, 3] = -r.T @ pos
    view[2, :] *= -1.0
    return view


def projection_matrix(cam: dict) -> np.ndarray:
    """GL-style perspective projection (Unity Camera.projectionMatrix)."""
    f = 1.0 / np.tan(np.deg2rad(cam["fov_deg"]) / 2.0)
    aspect = cam["width"] / cam["height"]
    n, fa = cam["near"], cam["far"]
    p = np.zeros((4, 4))
    p[0, 0] = f / aspect
    p[1, 1] = f
    p[2, 2] = -(fa + n) / (fa - n)
    p[2, 3] = -2.0 * fa * n / (fa - n)
    p[3, 2] = -1.0
    return p


def forward(cam: dict) -> np.ndarray:
    """Unity transform.forward: local +Z in world space."""
    return trs_matrix(cam["position"], cam["rotation"])[:3, 2].copy()


def dragon_scene(width: int = 1920, height: int = 1080,
                 tri_budget: int = 400_000) -> dict:
    """DragonScene.unity: the ground plane scaled 100x (1000 x 1000 at
    y = 0) and the dragon stand-in at (25, -2, 0) rotated 180 degrees
    about Y, with its four cameras."""
    pv, pf = unity_plane()
    dv, df, dn = dragon_standin(tri_budget)
    parts = [
        _world(pv, pf, None, trs_matrix((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0),
                                        (100.0, 100.0, 100.0))),
        _world(dv, df, dn, trs_matrix((25.0, -2.0, 0.0), (0.0, 1.0, 0.0, 0.0))),
    ]
    return {
        "name": "DragonScene",
        "triangles": np.concatenate([p[0] for p in parts]).astype(np.float32),
        "corner_normals": np.concatenate([p[1] for p in parts]).astype(np.float32),
        "cameras": {c[0]: camera(c[0], width, height) for c in CAMERAS},
    }

