"""Exact swept-sphere vs triangle narrow phase, dense and masked.

Port of the JAX package's ``ops/narrow_phase.py`` (the reference's
SpatialStructureCollisionDetection.compute:41-233).  A sphere of radius r
moving along the unit velocity direction is tested against a triangle as

  * 2 ray-vs-triangle tests against the triangle plane offset by +-r*n
    (compute:174-198),
  * 3 ray-vs-edge-cylinder tests of radius r (compute:200-211),
  * 3 ray-vs-vertex-sphere tests of radius r (compute:213-224),

keeping the nearest sub-hit by squared distance and finally rejecting
hits beyond the step's travel (compute:226-231).  Every sub-test is
evaluated unconditionally over the candidate axis; comparison chains use
the reference's "keep previous unless strictly nearer" semantics, so NaN
lanes (parallel rays, etc.) lose exactly as their IEEE comparisons fail.

This is the plain PyTorch path of the phase-3 rescue
(core/step.py::spatial_collide_packed).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from particlesystemhybridcollisiondetection_tpu_torch.core import vec

_INF = float("inf")


def ray_triangle(p0, dirn, v0, v1, v2):
    """Ray vs single-sided-unbounded triangle (compute:67-101).  Returns
    (hit, t) with t the signed ray parameter (the span check bounds it)."""
    v1v0 = v1 - v0
    v2v0 = v2 - v0
    rov0 = p0 - v0
    n = vec.cross(v1v0, v2v0)
    q = vec.cross(rov0, dirn)
    d = 1.0 / vec.dot(dirn, n)
    u = d * vec.dot(-q, v2v0)
    v = d * vec.dot(q, v1v0)
    t = d * vec.dot(-n, rov0)
    # NaN u/v compare false -> hit with t possibly NaN; the keep-nearest
    # chains then reject the NaN distance, as in the reference
    miss = (u < 0.0) | (v < 0.0) | ((u + v) > 1.0)
    return ~miss, t


def ray_cylinder(p0, dirn, a, b, r):
    """Ray vs finite capped cylinder from a to b (compute:103-142), with
    the geometric cap test of the JAX package (point-in-disk at the
    cap-plane crossing; robust where the reference's ``|k1 + k2*t| < h``
    sits on a 0/0 knife-edge for rays parallel to the axis)."""
    ba = b - a
    oc = p0 - a
    baba = vec.dot(ba, ba)
    bard = vec.dot(ba, dirn)
    baoc = vec.dot(ba, oc)
    k2 = baba - bard * bard
    k1 = baba * vec.dot(oc, dirn) - baoc * bard
    k0 = baba * vec.dot(oc, oc) - baoc * baoc - r * r * baba
    h = k1 * k1 - k2 * k0
    hs = torch.sqrt(h)  # NaN when h < 0; all compares below then fail
    t_body = (-k1 - hs) / k2
    y = baoc + t_body * bard
    body_hit = (y > 0.0) & (y < baba)
    yc = torch.where(y < 0.0, 0.0, baba)
    t_cap = (yc - baoc) / bard
    q = oc + dirn * t_cap[None] - ba * (yc / baba)[None]
    cap_hit = (h >= 0.0) & (vec.dot(q, q) < r * r)
    hit = body_hit | cap_hit
    t = torch.where(body_hit, t_body, t_cap)
    return hit, t


def ray_sphere(p0, dirn, c, r):
    """Ray vs sphere (compute:144-161): hit whenever the discriminant is
    >= 0, even behind the origin; the span check does the bounding."""
    oc = c - p0
    proj = vec.dot(oc, dirn)
    disc = r * r - (vec.dot(oc, oc) - proj * proj)
    hit = disc >= 0.0
    t = proj - torch.sqrt(disc)  # NaN when disc < 0 (masked by hit)
    return hit, t


def _keep_nearest(best_t2, best_t, hit, t):
    """Update iff hit and t^2 strictly < best^2 (NaN t keeps the previous
    best, mirroring the HLSL ``dot(cur,cur) < dot(prev,prev)`` chains)."""
    t2 = t * t
    take = hit & (t2 < best_t2)
    return torch.where(take, t2, best_t2), torch.where(take, t, best_t)


class TriangleHits(NamedTuple):
    """Per-candidate narrow phase result (before the cross-candidate
    reduction)."""

    hit: torch.Tensor  # bool[...]
    t: torch.Tensor  # f32[...] signed nearest sub-hit parameter
    t2: torch.Tensor  # f32[...] squared distance (inf where no usable hit)
    normal: torch.Tensor  # f32[3, ...] triangle normal flipped against dirn


def particle_vs_triangles_pre(p0, dirn, seg_len2, v0, v1, v2, r) -> TriangleHits:
    """Swept sphere vs candidate triangles; every argument pre-broadcast
    against the candidate vertex tensors (axis 0 = xyz for vectors)."""
    # triangle normal, oriented against the motion (compute:169-171)
    n = vec.normalize(vec.cross(v1 - v0, v2 - v0))
    n = vec.where(vec.dot(n, dirn) <= 0.0, n, -n)
    off = n * r[None]

    shape = v0.shape[1:]
    best_t2 = torch.full(shape, _INF, dtype=p0.dtype, device=p0.device)
    best_t = torch.full(shape, _INF, dtype=p0.dtype, device=p0.device)
    any_hit = torch.zeros(shape, dtype=torch.bool, device=p0.device)

    for sgn in (1.0, -1.0):  # offset triangle planes (compute:174-198)
        hit, t = ray_triangle(
            p0, dirn, v0 + sgn * off, v1 + sgn * off, v2 + sgn * off
        )
        any_hit = any_hit | hit
        best_t2, best_t = _keep_nearest(best_t2, best_t, hit, t)

    verts = (v0, v1, v2)
    for i in range(3):  # edge cylinders (compute:200-211)
        hit, t = ray_cylinder(p0, dirn, verts[i], verts[(i + 1) % 3], r)
        any_hit = any_hit | hit
        best_t2, best_t = _keep_nearest(best_t2, best_t, hit, t)

    for i in range(3):  # vertex spheres (compute:213-224)
        hit, t = ray_sphere(p0, dirn, verts[i], r)
        any_hit = any_hit | hit
        best_t2, best_t = _keep_nearest(best_t2, best_t, hit, t)

    # span check (compute:226-231); best_t2 stays +inf when only NaN
    # sub-hits occurred, so those reject here
    hit = any_hit & (best_t2 <= seg_len2)
    t2 = torch.where(hit, best_t2, _INF)
    return TriangleHits(hit=hit, t=best_t, t2=t2, normal=n)


def spatial_response(pos, vel, dirn, hit, t, normal, gravity, dt, radius,
                     restitution, backoff):
    """Collision response of the spatial method (compute:332-352).

    vel' = reflect(dir, n)*(bounce*|v|) - g*dt
    pos' = colPoint - dir*(backoff*r) + refl*(|end-colPoint|*bounce)

    The ``- g*dt`` term pre-compensates the integrator that runs right
    after collision detection each step (ParticleSys.cs:480-489).
    """
    col_point = pos + dirn * t[None]
    refl = vec.normalize(vec.reflect(dirn, normal))
    end_pos = pos + vel * dt
    col_to_end = vec.norm(end_pos - col_point)
    speed = vec.norm(vel)

    new_vel = refl * (restitution * speed)[None] - gravity[:, None] * dt
    new_pos = (
        col_point
        - dirn * (backoff * radius)[None]
        + refl * (col_to_end * restitution)[None]
    )
    return vec.where(hit, new_pos, pos), vec.where(hit, new_vel, vel)
