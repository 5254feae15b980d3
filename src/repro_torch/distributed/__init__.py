"""``repro_torch.distributed``: the port's counterpart of
``repro/distributed/`` on ``torch.distributed``: the sharding rule table
and its DTensor placements (``sharding``), activation-sharding hints
(``hints``) and int8 cross-pod gradient compression (``compression``)."""
