"""The benchmark of the PyTorch/CUDA port: one run of one cell per call of
``run.py``; configurations, traffic mixes, cells and metrics as files."""
