"""Data- and model-parallel training and serving over several GPUs
(counterpart of bevrender_tpu/parallel/mesh.py's data and model axes):
``parallel.dist``."""
