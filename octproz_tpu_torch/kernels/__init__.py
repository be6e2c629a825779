"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the wrappers the pipeline calls (see fused_prep)."""
