"""Utilities: phase timers, CUDA-event benchmark helpers and profiler
regions."""
