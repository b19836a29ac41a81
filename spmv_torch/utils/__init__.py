"""Utilities: phase timers and CUDA-event benchmark helpers."""
