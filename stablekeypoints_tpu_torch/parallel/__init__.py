"""Data and tensor parallel over GPUs, one process a device: the mesh
(`mesh.py`) and the UNet's Megatron split over its 'model' axis
(`tensor.py`)."""
