"""Utilities: throughput metering, profiling, checkpointing and CUDA graphs."""
