"""The comm layer of the port: the helper API's collectives
(``collectives``) over torch.distributed or the native host group
(``host_backend``, with the two-level ``hier`` ring and the ``sanitizer``),
the torch.distributed ``primitives``, and the numpy ``wire`` format."""
