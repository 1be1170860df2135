"""Multi-device layer on ``torch.distributed``: one process per rank.

``data_parallel`` makes the mesh (the first n ranks of the world) and
splits the particle axis into contiguous slices (the sorted pipeline's
``mesh=`` runs on them); ``domain`` splits space into slabs along x with
a halo exchange between neighbour ranks; ``dryrun`` spawns ranks, on the
card or as gloo ranks on the CPU, and drives both.
"""
