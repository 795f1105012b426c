"""Processed-dataset loading and serialization."""
