"""Multi-device drivers on torch.distributed, one rank a device (SPMD).

Counterpart of ``fthmc_tpu/parallel``: ``mesh`` shards the chain axis
(whole-run samplers, data-parallel training); ``domain``, ``domain_flow``
and ``domain_fermion`` shard the lattice's row axis and exchange halo rows
between ring neighbours. A mesh is ``mesh.Mesh``: a process group, its
axis name, this rank, the group's size and this rank's device (NCCL on the
card, gloo on the CPU).
"""
