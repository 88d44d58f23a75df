"""Index tools: the port's copies of the JAX package's indexer and
indextool."""
