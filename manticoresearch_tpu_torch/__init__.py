"""manticoresearch_tpu_torch: the search engine's port to PyTorch and CUDA.

It runs beside the JAX package ``manticoresearch_tpu``, which stays the
reference. The port carries its own copies of that package's host modules
(schema, index builder, text pipeline, query parser and planner, the
packed store's build) and re-implements the device side in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a) where the JAX package had
Pallas kernels and where PyTorch has no exact primitive on the card. No
module of the port imports jax or the JAX package.
"""
__version__ = "0.1.0"
