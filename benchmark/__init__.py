"""The benchmark of the PyTorch and CUDA port: its harness, data
generators, plain reference and metric readers (``run.py`` is the entry
point)."""
