"""Launchers of the port (the counterpart of the JAX package's `launch/`):
`launch.train`, LM training on the synthetic token stream; `launch.dryrun`,
the dry-run of every (architecture x input shape) pair on H100 cards, with
its input specs (`launch.specs`), meshes (`launch.mesh`), analytic roofline
model (`launch.analysis`) and meta-trace mode (`launch.metatrace`)."""
