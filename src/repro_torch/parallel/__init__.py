"""The distributed layer of the port: the sharding rules
(:mod:`~repro_torch.parallel.sharding`), the mesh's groups and collectives
(:mod:`~repro_torch.parallel.comm`) and the placement of a model and its
train state on the mesh (:mod:`~repro_torch.parallel.shard`)."""
