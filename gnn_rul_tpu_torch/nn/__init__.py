"""Layers that torch.nn lacks, and shared encoders."""
