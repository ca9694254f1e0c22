"""Training of the port: the config parser, Adam with the JAX package's lr
groups and decay, checkpoints in the JAX format, and the trainer."""
