"""Data parallelism over the particle axis, one process per rank.

Against a *static* scene, particles are embarrassingly parallel, so:

  * every rank holds a contiguous slice of the particle axis
    (``shard_state``);
  * every rank builds its own copy of the (small, read-only) scene
    tables -- CSR grid, triangle soup, camera textures -- so the tables
    are replicated;
  * every rank runs the unchanged single-device step on its slice.

A step runs no collective of its own.  The collectives are the readout
(``gather_state``) and the diagnostics summed over the mesh (``sum_ints``,
``sum_int_list``): the window overflow a sorted step returns with
``with_stats``, once per step, and the overflows of a persistent runner's
call, once per call.  The one per-step collective on the hot path is the
persistent runner's under ``resort_every="auto"``, which decides each
re-sort from the overflow summed over the ranks: ``all_sum`` of a device
scalar, inside the runner's captured step where the backend is NCCL, so
the host reads only the flag derived from the sum.  Spatial domain
decomposition with a halo exchange between neighbour ranks (for
particle-particle interaction at scale) lives in parallel/domain.py.

The mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over the
first n ranks of the default process group's world (``make_mesh(n)``,
as the JAX package's takes the first n devices; all of them by
default).  Every function here uses the mesh's own group, size and rank,
never the world's.  The backend of a mesh's group is chosen from the
device count (``choose_backend``) for the group's members: NCCL when
each member has a GPU of its own, gloo for CPU ranks and for several
ranks sharing one card.  So a mesh over part of a gloo world can run
over NCCL.  Under gloo the collectives take host tensors, so a rank on a
GPU copies what it sends and receives through host memory; its compute
stays on the card.

The ranks' GPUs are counted on the rank's own host: under ``torchrun``
from ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, which ``parallel/dryrun.py``
sets in the ranks it spawns; without them every rank is taken to be on
one host.

JAX's ``state_sharding`` (a pytree of ``NamedSharding``s) has nothing to
port beyond ``shard_state`` and ``gather_state``: the layout it names,
the particle axis split into contiguous slices over the ranks, is what
the one cuts and the other joins.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from particlesystemhybridcollisiondetection_tpu_torch.config import PARTICLE_PAD
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    resolve_device,
)

DATA_AXIS = "data"


def _local(name: str, default: int) -> int:
    """``LOCAL_RANK`` or ``LOCAL_WORLD_SIZE`` where the launcher set it."""
    return int(os.environ.get(name, default))


def choose_backend(device_type: str, n_ranks: int) -> str:
    """The backend for a group of the first ``n_ranks`` ranks of the
    world (the whole world, or a mesh over part of it): "nccl" when each
    of its members on this host (at most ``LOCAL_WORLD_SIZE`` of them,
    where the launcher set it) has a GPU of its own; "gloo" for CPU
    ranks and for members sharing a card (NCCL refuses two ranks on one
    GPU).  Decided from the device count, never by trying."""
    if device_type == "cuda":
        resolve_device("cuda")
        on_host = min(n_ranks, _local("LOCAL_WORLD_SIZE", n_ranks))
        if torch.cuda.device_count() >= on_host:
            return "nccl"
    return "gloo"


def _select_gpu(rank: int) -> None:
    """Run this rank on ``cuda:{local rank % device_count}``."""
    torch.cuda.set_device(_local("LOCAL_RANK", rank) % torch.cuda.device_count())


def init_ranks(rank: int, world_size: int, init_method: str,
               device_type: str = "cuda") -> str:
    """Join the default process group as ``rank`` of ``world_size`` with
    the backend ``choose_backend`` picks; a GPU rank first selects
    ``cuda:{local rank % device_count}``.  Returns the backend's name."""
    backend = choose_backend(device_type, world_size)
    if device_type == "cuda":
        _select_gpu(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS,
              device_type: str = "cuda") -> DeviceMesh | None:
    """1-D mesh over the first ``n_devices`` ranks of the default process
    group's world (which must be initialized; all of it by default), as
    the JAX package's ``make_mesh(n)`` takes the first n devices.

    Every rank of the world calls it: building a group is collective.
    Ranks 0..n-1 get the mesh; the others take part in building its
    group and get ``None``, and sit out whatever runs on the mesh.  With
    n below the world size the group's backend is ``choose_backend``'s
    for its n members, and an NCCL group makes its communicator here (a
    communicator made on the group's first collective inside a CUDA
    graph's capture would break the capture).  n above the world size
    raises (the JAX package would take fewer devices than asked).  A GPU
    rank runs on ``cuda:{local rank % device_count}``; the CPU only when
    ``device_type="cpu"``."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n}): a mesh over {n} ranks, but the "
                         f"world has {world}")
    if device_type == "cuda":
        resolve_device("cuda")
        _select_gpu(dist.get_rank())
    if n == world:
        return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))
    backend = choose_backend(device_type, n)
    group = dist.new_group(list(range(n)), backend=backend)
    if dist.get_rank() >= n:
        return None
    mesh = DeviceMesh.from_group(group, device_type, mesh_dim_names=(axis_name,))
    if backend == "nccl":
        dist.all_reduce(torch.zeros(1, device=rank_device(mesh)), group=group)
    return mesh


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_mesh(mesh) -> DeviceMesh:
    if mesh is None:
        raise TypeError("no mesh: this rank is outside the mesh (make_mesh "
                        "returned None) and has nothing to run on it")
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(f"mesh must be a 1-D torch.distributed DeviceMesh, "
                        f"got {mesh!r}")
    return mesh


def through_host(mesh: DeviceMesh) -> bool:
    """Whether collectives must stage device tensors through host memory
    (gloo moves CPU tensors only)."""
    return mesh.device_type != "cpu" and dist.get_backend(mesh.get_group()) == "gloo"


def all_sum(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Elementwise sum of ``t`` over the mesh, returned on every rank on
    ``t``'s device (the counterpart of ``psum``)."""
    buf = t.cpu() if through_host(mesh) else t.clone()
    dist.all_reduce(buf, group=mesh.get_group())
    return buf.to(t.device)


def sum_int_list(values: list[int], mesh: DeviceMesh) -> list[int]:
    """Host integers summed elementwise over the mesh (one all_reduce)."""
    dev = torch.device("cpu") if through_host(mesh) else rank_device(mesh)
    return all_sum(torch.tensor(values, dtype=torch.int64, device=dev),
                   mesh).tolist()


def sum_ints(value: int, mesh: DeviceMesh) -> int:
    """A host integer summed over the mesh (one scalar all_reduce)."""
    return sum_int_list([value], mesh)[0]


def state_to_rows(state: ParticleState) -> torch.Tensor:
    """f32[9, n]: pos, vel, radius, restitution and the int32 collision
    counter's bits, so one buffer carries a slice exactly."""
    return torch.cat([state.pos, state.vel, state.radius[None],
                      state.restitution[None],
                      state.collisions.view(torch.float32)[None]], dim=0)


def rows_to_state(rows: torch.Tensor) -> ParticleState:
    """The inverse of ``state_to_rows``."""
    return ParticleState(
        pos=rows[0:3].contiguous(), vel=rows[3:6].contiguous(),
        collisions=rows[8].contiguous().view(torch.int32),
        radius=rows[6].contiguous(), restitution=rows[7].contiguous(),
    )


def shard_state(state: ParticleState, mesh: DeviceMesh) -> ParticleState:
    """This rank's contiguous slice of a global state, on its device.
    The padded particle count must divide by ``world * PARTICLE_PAD``
    (the sorted pipeline's block of 1024 per rank)."""
    check_mesh(mesh)
    n = state.pos.shape[-1]
    world = mesh.size()
    if n % (world * PARTICLE_PAD):
        raise ValueError(f"N={n} does not divide by {world} ranks x "
                         f"{PARTICLE_PAD}")
    m = n // world
    r = mesh.get_local_rank()
    dev = rank_device(mesh)
    return ParticleState(*(
        (x[..., r * m:(r + 1) * m]).contiguous().to(dev) for x in state))


def gather_state(local: ParticleState, mesh: DeviceMesh) -> ParticleState:
    """The global state back from every rank's slice (an ``all_gather``,
    on every rank): the readout that compares a mesh run with one
    device.  Every rank's slice has the same length (``shard_state``'s
    and the domain step's do)."""
    check_mesh(mesh)
    rows = state_to_rows(local)
    if through_host(mesh):
        rows = rows.cpu()
    parts = [torch.empty_like(rows) for _ in range(mesh.size())]
    dist.all_gather(parts, rows, group=mesh.get_group())
    return rows_to_state(torch.cat(parts, dim=1).to(local.pos.device))


def make_dp_step(
    step: Callable[[ParticleState], ParticleState],
    mesh: DeviceMesh,
) -> Callable[[ParticleState], ParticleState]:
    """Run a single-device step on this rank's slice.

    The step was built on this rank (its scene tables are this rank's
    copy: replicated); it takes and returns the rank's slice and runs no
    collective.
    """
    check_mesh(mesh)
    dev = rank_device(mesh)

    def dp_step(local: ParticleState) -> ParticleState:
        if local.pos.device != dev:
            raise ValueError(f"the slice is on {local.pos.device}, this "
                             f"rank computes on {dev}")
        return step(local)

    return dp_step
