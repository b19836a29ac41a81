"""Utilities: phase timers, CUDA-event benchmark helpers and the port's
spans."""
