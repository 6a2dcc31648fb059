"""Data parallel over GPUs: one process a device (`mesh.py`)."""
