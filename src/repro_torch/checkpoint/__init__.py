"""Checkpoints of the port's trainer, in the JAX package's on-disk format."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
