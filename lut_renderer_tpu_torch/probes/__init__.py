"""Measurement probes of the port's kernels, run on the card; never on a
render path.

``harness`` holds the seeded inputs and the CUDA-event timer that
``chip_smoke.py`` and the probes share; ``kernel_b`` splits kernel B's time
into stages and holds it against another revision's kernel B."""
