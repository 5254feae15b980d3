"""``repro_torch.distributed``: the port's counterpart of
``repro/distributed/``.  Only the sharding rules' shape predicates are here
so far (``sharding``); the rest of the package comes with multi-GPU
training (ROADMAP item 13)."""
