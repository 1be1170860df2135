"""Multi-device layer on ``torch.distributed``: one process per rank.

``data_parallel`` splits the particle axis into contiguous slices (the
sorted pipeline's ``mesh=`` runs on them); ``domain`` splits space into
slabs along x with a halo exchange between neighbour ranks; ``dryrun``
spawns gloo ranks on the CPU and drives both.
"""
