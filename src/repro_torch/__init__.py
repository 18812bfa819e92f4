"""PyTorch/CUDA port of the ParallelKittens reproduction (see src/repro for
the JAX/Pallas reference it is held against)."""
