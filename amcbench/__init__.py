"""The benchmark of the PyTorch and CUDA port (``repro_torch``): served
automatic modulation classification on one card, driven by the data files
beside this package (``BENCHMARK.json`` names the cells)."""
