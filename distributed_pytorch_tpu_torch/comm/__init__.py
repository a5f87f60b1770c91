"""Collectives of the port (``collectives``) over torch.distributed."""
