"""Data-parallel training and serving over several GPUs (counterpart of
bevrender_tpu/parallel/mesh.py's data axis): ``parallel.dist``."""
