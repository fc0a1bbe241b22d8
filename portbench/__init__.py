"""The benchmark of the PyTorch / CUDA port (``repro_torch``) on one card."""
