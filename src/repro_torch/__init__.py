"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The layout mirrors ``repro`` (configs/, kernels/, models/, serving/,
launch/) so each module has an obvious counterpart.  Nothing here imports
JAX or the ``repro`` package; where a plain-Python module of the reference
is needed, the port keeps its own trimmed copy.
"""
