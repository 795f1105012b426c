"""Operators: windows, encodings, graphs, message passing, kernels."""
