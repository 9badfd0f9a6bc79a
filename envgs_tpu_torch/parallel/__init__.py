"""Multi-process training of the port on torch.distributed (port of
envgs_tpu/parallel/): one process a rank, a JAX mesh axis a process group.

- collectives.py: differentiable psum / pmean / pmax / all_gather /
  ppermute over an Axis (a process group);
- multihost.py: ranks, the rank-0 services' gate, barrier, frame sharding,
  host sums, the default group from torchrun's environment;
- sharding.py: the band-parallel train step (pixels split in bands of
  whole tile rows, the parameter gradients all-reduced);
- splat_sharding.py: the splat-slab passes and train step (the pair
  pipelines split by depth-rank slabs, the blends composed).
"""
