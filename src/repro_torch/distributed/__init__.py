"""The port's multi-device pieces: the sharding rules (``sharding``) and
the recorded collectives over ``torch.distributed`` (``collectives``)."""
