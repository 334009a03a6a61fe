"""The benchmark of the PyTorch and CUDA port (``repro_torch``): cells,
configurations, traffic, per-layer readers, work laws and the plain
reference. See README.md."""
