"""The runners, the trace reader and the comparison that decides
``correct``."""
