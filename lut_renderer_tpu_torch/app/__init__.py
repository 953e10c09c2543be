"""app: the port's user-facing entry points (the CLI) and its copies of
the JAX package's backend-free app helpers: settings, LUT history, naming,
presets, smart defaults, the ProRes estimate, task creation and the queue
monitor."""
