"""Offline preprocessing (numpy, no pandas), processed-dataset loading and
serialization."""
