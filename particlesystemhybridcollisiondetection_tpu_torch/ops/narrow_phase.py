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

Shapes: ``p0, dirn`` [3, N] segment start and unit direction; ``v0, v1,
v2`` [3, N, K] candidate vertices (``particle_vs_triangles``) or
pre-broadcast ([3, G, N] in the packed path, ``particle_vs_triangles_pre``);
``radius`` [N].  The nearest hit across candidates is the first minimum of
the squared distance (``nearest_hit``, ``swept_collide_stream``).  These
are the plain PyTorch paths of the oracle steps (brute force, "dense",
"stream") and of the packed step and phase-3 rescue.
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


def particle_vs_triangles(p0, dirn, seg_len2, v0, v1, v2, radius) -> TriangleHits:
    """Swept sphere vs a batch of candidate triangles, candidates on the
    LAST axis (v0 is [3, N, K]); ``seg_len2`` [N] is |vel*dt|^2
    (compute:226-230), ``radius`` [N].  Mirrors
    ParticleTriangleIntersection (compute:163-233)."""
    return particle_vs_triangles_pre(
        p0[..., None], dirn[..., None], seg_len2[..., None], v0, v1, v2,
        radius[..., None],
    )


class NearestHit(NamedTuple):
    hit: torch.Tensor  # bool[N] any candidate hit
    t: torch.Tensor  # f32[N] signed parameter of the winning hit
    normal: torch.Tensor  # f32[3, N] winning triangle normal (flipped)


def nearest_hit(hits: TriangleHits) -> NearestHit:
    """Cross-candidate reduction: the first candidate with the smallest
    squared distance (``torch.argmin`` returns the first minimum, as
    ``jnp.argmin`` does)."""
    k = torch.argmin(hits.t2, dim=-1, keepdim=True)
    t = torch.gather(hits.t, -1, k)[..., 0]
    hit = torch.gather(hits.hit, -1, k)[..., 0]
    kn = k[None].expand((3,) + tuple(k.shape))
    normal = torch.gather(hits.normal, -1, kn)[..., 0]
    return NearestHit(hit=hit, t=t, normal=normal)


def swept_collide_stream(p0, dirn, seg_len2, radius, gather_fn,
                         num_candidates: int) -> NearestHit:
    """Streaming nearest-hit reduction over candidate slots: the
    semantics of ``particle_vs_triangles`` + ``nearest_hit`` with only
    [N]-shaped tensors, one candidate slot per iteration.

    ``gather_fn(j) -> (v0, v1, v2, valid)`` supplies candidate slot j of
    every particle: vertices [3, N], validity [N].  A later slot replaces
    the running best only when strictly nearer, so the first-seen
    candidate wins ties, as the argmin of ``nearest_hit`` does."""
    n = p0.shape[-1]
    best_t2 = torch.full((n,), _INF, dtype=p0.dtype, device=p0.device)
    best_t = torch.full((n,), _INF, dtype=p0.dtype, device=p0.device)
    best_n = torch.zeros((3, n), dtype=p0.dtype, device=p0.device)
    any_hit = torch.zeros((n,), dtype=torch.bool, device=p0.device)
    for j in range(num_candidates):
        v0, v1, v2, valid = gather_fn(j)
        hits = particle_vs_triangles(p0, dirn, seg_len2, v0[..., None],
                                     v1[..., None], v2[..., None], radius)
        hit_j = hits.hit[..., 0] & valid
        t2_j = torch.where(hit_j, hits.t2[..., 0], _INF)
        take = t2_j < best_t2  # strict: the first-seen candidate wins ties
        best_t2 = torch.where(take, t2_j, best_t2)
        best_t = torch.where(take, hits.t[..., 0], best_t)
        best_n = vec.where(take, hits.normal[..., 0], best_n)
        any_hit = any_hit | hit_j
    return NearestHit(hit=any_hit & (best_t2 < _INF), t=best_t, normal=best_n)


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
