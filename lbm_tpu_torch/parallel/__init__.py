"""Spatial domain decomposition on torch.distributed (torch port of
lbm_tpu/parallel): the process group (mesh), the ring exchange of the
shards' edge planes and the dense halo step (halo), the sharded kernel
step (sharded), spawning the ranks of a run (launch) and the multi-rank
dry run (dryrun)."""
