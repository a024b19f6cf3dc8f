"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, Triton for RMSNorm),
each beside its plain PyTorch twin in ``ref``; ``ops`` dispatches."""
