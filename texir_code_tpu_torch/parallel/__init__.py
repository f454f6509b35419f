"""Multi-device paths on torch.distributed, one rank per device: the
process group and its collectives (mesh, multihost), the sharded IrT bake
(bake), atlas tensor parallelism (atlas_tp) and the dry run (dryrun)."""
