"""Iterative solvers built on SpMV."""
