"""Hand-written Hopper kernels, their plain PyTorch versions (``ref``) and
the routing layer (``ops``). Kernel sources live in ``csrc/`` and are
compiled with ``nvcc`` at first use (``_build``)."""
