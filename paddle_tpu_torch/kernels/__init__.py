"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Kernel modules build ``csrc/*.cu`` on first use (:mod:`._build`); nothing
compiles or loads at import."""
