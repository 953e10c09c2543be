"""app: the port's user-facing entry points (the CLI). Persistence,
naming, presets and defaults are the JAX package's lut_renderer_tpu.app,
which imports no jax."""
