"""Launchers of the port (the counterpart of the JAX package's `launch/`):
`launch.train`, LM training on the synthetic token stream."""
