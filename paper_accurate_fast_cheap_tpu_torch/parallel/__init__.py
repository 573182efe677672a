"""Parallel forms on ``torch.distributed`` (port of the JAX package's
``parallel/``): the collectives, meshes and parameter layouts, sequence
parallelism through K1's carried state, the GPipe pipeline and the
multichip dry run."""
