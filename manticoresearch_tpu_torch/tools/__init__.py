"""Index tools: the port's copy of the JAX package's indextool."""
