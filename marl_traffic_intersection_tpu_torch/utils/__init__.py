"""Utilities: throughput metering, profiling and checkpointing."""
from .checkpoint import checkpoint_exists, restore_checkpoint, save_checkpoint
from .profiling import StepsPerSecond, trace_profile

__all__ = ["StepsPerSecond", "trace_profile", "checkpoint_exists", "save_checkpoint",
           "restore_checkpoint"]
