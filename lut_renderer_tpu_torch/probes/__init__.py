"""Measurement probes of the port's kernels, run on the card; never on a
render path.

``harness`` holds the seeded inputs, the CUDA-event timer and the library
of stage builds (``probe_library``, apart from the render library) that
``chip_smoke.py`` and the probes share; ``kernel_b`` splits kernel B's time
into stages and holds it against another revision's kernel B, and
``kernel_ac`` does the same for kernels A and C."""
