"""Triangle meshes: procedural primitives, OBJ and binary-FBX loading,
and Unity-convention TRS transforms.

The reference scrapes every MeshFilter in the Unity scene into a world-space
triangle soup at init (ParticleSys.cs:1017-1070).  Here a Scene is described
explicitly as (mesh, transform) pairs and flattened the same way.

Everything in this module is host-side NumPy: scene setup is a one-time
cost, device arrays are produced by the broad-phase builders.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class TriangleMesh:
    """Indexed triangle mesh in local (model) space.

    ``corner_normals`` (optional, f64[T, 3, 3] aligned with ``faces``) are
    per-corner shading normals -- the authored smooth normals FBX stores
    ByPolygonVertex.  ``None`` means flat shading (face normals).
    """

    vertices: np.ndarray  # f64[V, 3]
    faces: np.ndarray  # i64[T, 3]
    name: str = ""
    corner_normals: Optional[np.ndarray] = None  # f64[T, 3, 3]

    @property
    def num_triangles(self) -> int:
        return len(self.faces)

    def triangles(self) -> np.ndarray:
        """f64[T, 3(vert), 3(xyz)] triangle soup."""
        return self.vertices[self.faces]

    def with_smooth_normals(self) -> "TriangleMesh":
        """Copy with area-weighted smooth vertex normals (the standard
        importer behavior for meshes authored without normals)."""
        tris = self.triangles()
        fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        vn = np.zeros_like(self.vertices)
        for k in range(3):  # cross length = 2*area: area weighting built in
            np.add.at(vn, self.faces[:, k], fn)
        vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-300)
        return dataclasses.replace(self, corner_normals=vn[self.faces])


@dataclasses.dataclass(frozen=True)
class Transform:
    """Unity TRS: position, rotation quaternion (x, y, z, w), scale."""

    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0, 1.0)  # quaternion xyzw
    scale: tuple = (1.0, 1.0, 1.0)

    def matrix(self) -> np.ndarray:
        """4x4 local->world matrix, column-vector convention."""
        x, y, z, w = self.rotation
        # Standard quaternion -> rotation matrix (Unity normalizes).
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
        m[:3, :3] = rot @ np.diag(self.scale)
        m[:3, 3] = self.position
        return m

    def apply(self, points: np.ndarray) -> np.ndarray:
        """Transform [..., 3] points to world space."""
        m = self.matrix()
        return points @ m[:3, :3].T + m[:3, 3]

    def forward(self) -> np.ndarray:
        """Unity transform.forward: local +Z in world space."""
        return self.matrix()[:3, 2].copy()


IDENTITY = Transform()


def flatten_scene(
    instances: Sequence[tuple[TriangleMesh, Transform]],
) -> np.ndarray:
    """World-space triangle soup f32[T, 3, 3] from (mesh, transform) pairs.

    Mirrors GetBvhTrianglesSortedWithMortonCodes's scene scrape
    (ParticleSys.cs:1024-1050), minus the Morton sort (the grid broad phase
    does its own spatial ordering).
    """
    out = []
    for mesh, tf in instances:
        out.append(tf.apply(mesh.triangles()))
    if not out:
        return np.zeros((0, 3, 3), dtype=np.float32)
    return np.concatenate(out, axis=0).astype(np.float32)


def flatten_scene_normals(
    instances: Sequence[tuple[TriangleMesh, Transform]],
) -> np.ndarray:
    """World-space per-corner shading normals f32[T, 3, 3], aligned with
    ``flatten_scene``'s soup.

    Meshes without authored ``corner_normals`` fall back to face normals
    (flat shading -- identical to the pre-round-2 rasterizer).  Normals
    transform by the inverse-transpose of the linear part and are
    renormalized, matching ``normalize(mul((float3x3)unity_ObjectToWorld,
    v.normal))`` in NormalPrePass.shader:30 for Unity's uniform-scale
    benchmark transforms (for non-uniform scale the inverse-transpose is
    the correct general form).
    """
    out = []
    for mesh, tf in instances:
        if mesh.corner_normals is not None:
            cn = mesh.corner_normals
        else:
            tris = mesh.triangles()
            fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
            cn = np.broadcast_to(fn[:, None, :], tris.shape)
        lin = tf.matrix()[:3, :3]
        wn = cn @ np.linalg.inv(lin)  # rows @ inv(M) == (inv(M).T @ n).T
        wn = wn / np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-300)
        out.append(wn)
    if not out:
        return np.zeros((0, 3, 3), dtype=np.float32)
    return np.concatenate(out, axis=0).astype(np.float32)


# --- procedural primitives (Unity built-in shapes) --------------------------


def unity_plane(segments: int = 10) -> TriangleMesh:
    """Unity's built-in Plane: 10x10 units in XZ, +Y normal, 10x10 quads."""
    n = segments + 1
    xs = np.linspace(5.0, -5.0, n)  # Unity plane spans +5..-5
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
            # winding chosen for +Y facing with the axes above
            faces.append([a, cc, b])
            faces.append([b, cc, d])
    return TriangleMesh(verts, np.asarray(faces, dtype=np.int64), "plane")


def unity_cube(size: float = 1.0) -> TriangleMesh:
    """Unit cube centred at origin, 12 triangles, outward winding."""
    h = size / 2.0
    v = np.array(
        [
            [-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
            [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h],
        ]
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # -z
            [4, 5, 6], [4, 6, 7],  # +z
            [0, 1, 5], [0, 5, 4],  # -y
            [3, 7, 6], [3, 6, 2],  # +y
            [0, 4, 7], [0, 7, 3],  # -x
            [1, 2, 6], [1, 6, 5],  # +x
        ],
        dtype=np.int64,
    )
    return TriangleMesh(v, f, "cube")


def uv_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 24) -> TriangleMesh:
    theta = np.linspace(0.0, np.pi, rings + 1)
    phi = np.linspace(0.0, 2 * np.pi, sectors, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    verts = radius * np.stack(
        [np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], axis=-1
    ).reshape(-1, 3)
    faces = []
    for r in range(rings):
        for s in range(sectors):
            a = r * sectors + s
            b = r * sectors + (s + 1) % sectors
            c = (r + 1) * sectors + s
            d = (r + 1) * sectors + (s + 1) % sectors
            if r > 0:
                faces.append([a, b, c])
            if r < rings - 1:
                faces.append([b, d, c])
    return TriangleMesh(verts, np.asarray(faces, dtype=np.int64), "sphere")


def cube_sphere(n: int = 64, radius: float = 1.0) -> TriangleMesh:
    """Quad-sphere: 6 cube faces of n x n quads projected to the sphere.

    Near-uniform triangle density (a uv-sphere crams hundreds of tiny
    triangles into the pole cells, which poisons uniform-grid broad
    phases).
    """
    verts = []
    faces = []
    axes = [
        (0, 1, 2, +1.0), (0, 1, 2, -1.0),
        (1, 2, 0, +1.0), (1, 2, 0, -1.0),
        (2, 0, 1, +1.0), (2, 0, 1, -1.0),
    ]
    offset = 0
    for (a, b, c, s) in axes:
        lin = np.linspace(-1.0, 1.0, n + 1)
        uu, vv = np.meshgrid(lin, lin, indexing="ij")
        p = np.zeros(uu.shape + (3,))
        p[..., a] = uu
        p[..., b] = vv
        p[..., c] = s
        p = p / np.linalg.norm(p, axis=-1, keepdims=True)
        verts.append(p.reshape(-1, 3) * radius)
        for i in range(n):
            for j in range(n):
                q = offset + i * (n + 1) + j
                faces.append([q, q + 1, q + n + 1])
                faces.append([q + 1, q + n + 2, q + n + 1])
        offset += (n + 1) * (n + 1)
    return TriangleMesh(
        np.concatenate(verts), np.asarray(faces, dtype=np.int64), "cube_sphere"
    )



def torus_knot(
    p: int = 2,
    q: int = 3,
    tube_radius: float = 0.35,
    knot_radius: float = 1.0,
    segments: int = 512,
    tube_segments: int = 64,
) -> TriangleMesh:
    """High-poly smooth closed surface: a tube of ``tube_segments``
    around a (p, q) torus knot sampled at ``segments`` points (65,536
    triangles at the defaults), a procedural collider.  Equal bit
    for bit to the JAX package's (the same float operations in the same
    order; the faces in the same order, built without a Python loop)."""
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    r = knot_radius * (2 + np.cos(q * t)) / 3.0
    center = np.stack(
        [r * np.cos(p * t), r * np.sin(q * t) * 0.6, r * np.sin(p * t)], axis=-1
    )
    # Frenet-ish frame
    nxt = np.roll(center, -1, axis=0)
    tang = nxt - center
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    up = np.array([0.0, 1.0, 0.0])
    side = np.cross(tang, up)
    side /= np.linalg.norm(side, axis=-1, keepdims=True) + 1e-12
    upv = np.cross(side, tang)

    ang = np.linspace(0, 2 * np.pi, tube_segments, endpoint=False)
    circ = (
        np.cos(ang)[None, :, None] * side[:, None, :]
        + np.sin(ang)[None, :, None] * upv[:, None, :]
    )
    verts = (center[:, None, :] + tube_radius * circ).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(segments, dtype=np.int64),
                       np.arange(tube_segments, dtype=np.int64), indexing="ij")
    a = i * tube_segments + j
    b = i * tube_segments + (j + 1) % tube_segments
    c = ((i + 1) % segments) * tube_segments + j
    d = ((i + 1) % segments) * tube_segments + (j + 1) % tube_segments
    faces = np.stack([np.stack([a, c, b], -1), np.stack([b, c, d], -1)], -2)
    return TriangleMesh(verts, faces.reshape(-1, 3), "torus_knot")


# --- OBJ -------------------------------------------------------------------


def load_obj(path: str, name: Optional[str] = None) -> TriangleMesh:
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriangleMesh(
        np.asarray(verts, dtype=np.float64),
        np.asarray(faces, dtype=np.int64),
        name or path,
    )


# --- minimal binary FBX (7.x) geometry reader --------------------------------
#
# Just enough of the Kaydara binary format to pull Vertices /
# PolygonVertexIndex and the unit scale out of stanford_bunny.fbx; not a
# general FBX importer.


def _read_fbx_node(buf: bytes, pos: int, version: int):
    if version >= 7500:
        end, nprops, _plen = struct.unpack_from("<QQQ", buf, pos)
        pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", buf, pos)
        pos += 12
    name_len = buf[pos]
    pos += 1
    name = buf[pos : pos + name_len].decode("latin1")
    pos += name_len
    if end == 0:
        return None, pos  # null record
    props = []
    for _ in range(nprops):
        tc = chr(buf[pos])
        pos += 1
        if tc in "CB":
            props.append(bool(buf[pos])); pos += 1
        elif tc == "Y":
            props.append(struct.unpack_from("<h", buf, pos)[0]); pos += 2
        elif tc == "I":
            props.append(struct.unpack_from("<i", buf, pos)[0]); pos += 4
        elif tc == "L":
            props.append(struct.unpack_from("<q", buf, pos)[0]); pos += 8
        elif tc == "F":
            props.append(struct.unpack_from("<f", buf, pos)[0]); pos += 4
        elif tc == "D":
            props.append(struct.unpack_from("<d", buf, pos)[0]); pos += 8
        elif tc in "fdil":
            alen, enc, clen = struct.unpack_from("<III", buf, pos)
            pos += 12
            fmt = {"f": "<%df", "d": "<%dd", "i": "<%di", "l": "<%dq"}[tc] % alen
            nbytes = struct.calcsize(fmt)
            if enc:
                raw = zlib.decompress(buf[pos : pos + clen])
                pos += clen
            else:
                raw = buf[pos : pos + nbytes]
                pos += nbytes
            props.append(np.asarray(struct.unpack(fmt, raw)))
        elif tc in "SR":
            slen = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            data = buf[pos : pos + slen]
            pos += slen
            props.append(data.decode("latin1", "replace") if tc == "S" else data)
        else:  # pragma: no cover
            raise ValueError(f"unknown FBX property type {tc!r}")
    children = []
    while pos < end:
        child, pos = _read_fbx_node(buf, pos, version)
        if child is not None:
            children.append(child)
    return (name, props, children), max(pos, end)


def _fbx_find(nodes, name):
    return [n for n in nodes if n[0] == name]


def load_fbx(path: str, name: Optional[str] = None) -> TriangleMesh:
    """Read the first Geometry from a binary FBX; applies unit scale.

    Unity imports stanford_bunny.fbx with useFileScale=1 and globalScale=1
    (stanford_bunny.fbx.meta), i.e. world units = file units *
    (UnitScaleFactor / 100).
    """
    buf = open(path, "rb").read()
    if buf[:20] != b"Kaydara FBX Binary  ":
        raise ValueError(f"{path}: not a binary FBX")
    version = struct.unpack_from("<I", buf, 23)[0]
    pos = 27
    roots = []
    while pos < len(buf):
        try:
            node, pos = _read_fbx_node(buf, pos, version)
        except (struct.error, IndexError):
            break
        if node is None:
            break
        roots.append(node)

    unit_scale = 1.0
    for gs in _fbx_find(roots, "GlobalSettings"):
        for p70 in _fbx_find(gs[2], "Properties70"):
            for prop in _fbx_find(p70[2], "P"):
                if prop[1] and prop[1][0] == "UnitScaleFactor":
                    unit_scale = float(prop[1][-1])

    verts = None
    polys = None
    norm_layer = None
    objects = _fbx_find(roots, "Objects")
    for obj in objects:
        for geo in _fbx_find(obj[2], "Geometry") + _fbx_find(obj[2], "Model"):
            vs = _fbx_find(geo[2], "Vertices")
            ps = _fbx_find(geo[2], "PolygonVertexIndex")
            if vs and ps:
                verts = np.asarray(vs[0][1][0], dtype=np.float64).reshape(-1, 3)
                polys = np.asarray(ps[0][1][0], dtype=np.int64)
                ln = _fbx_find(geo[2], "LayerElementNormal")
                if ln:
                    norm_layer = ln[0][2]
                break
        if verts is not None:
            break
    if verts is None:
        raise ValueError(f"{path}: no geometry found")

    # Shading normals (NormalPrePass.shader consumes these as NORMAL):
    # per-corner values, possibly behind an index table.
    per_corner_n = None  # f64[len(polys), 3] or None
    if norm_layer is not None:
        mapping = next(
            (n[1][0] for n in _fbx_find(norm_layer, "MappingInformationType")), ""
        )
        refmode = next(
            (n[1][0] for n in _fbx_find(norm_layer, "ReferenceInformationType")), ""
        )
        nvals = next((n[1][0] for n in _fbx_find(norm_layer, "Normals")), None)
        nidx = next((n[1][0] for n in _fbx_find(norm_layer, "NormalsIndex")), None)
        if nvals is not None:
            nvals = np.asarray(nvals, dtype=np.float64).reshape(-1, 3)
            if mapping == "ByPolygonVertex":
                if refmode == "IndexToDirect" and nidx is not None:
                    per_corner_n = nvals[np.asarray(nidx, dtype=np.int64)]
                elif refmode == "Direct" and len(nvals) == len(polys):
                    per_corner_n = nvals
            elif mapping in ("ByVertice", "ByVertex") and len(nvals) == len(verts):
                vid = np.where(polys < 0, ~polys, polys)
                per_corner_n = nvals[vid]

    # Decode polygons: negative index marks last vertex of a polygon
    # (value = ~index); fan-triangulate, tracking source corners so
    # per-corner normals stay aligned with the triangle list.
    faces = []
    corner_faces = []
    poly = []
    pcorn = []
    for c, idx in enumerate(polys):
        poly.append(~idx if idx < 0 else idx)
        pcorn.append(c)
        if idx < 0:
            for k in range(1, len(poly) - 1):
                faces.append([poly[0], poly[k], poly[k + 1]])
                corner_faces.append([pcorn[0], pcorn[k], pcorn[k + 1]])
            poly = []
            pcorn = []

    corner_normals = None
    if per_corner_n is not None and faces:
        corner_normals = per_corner_n[np.asarray(corner_faces, dtype=np.int64)]

    scale = unit_scale / 100.0  # Unity file-scale convention
    return TriangleMesh(
        verts * scale,
        np.asarray(faces, dtype=np.int64),
        name or path,
        corner_normals=corner_normals,
    )
