"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes launchers,
plain PyTorch versions (``ref``) and dispatch wrappers (``ops``).

Nothing is compiled at import: ``build`` runs nvcc the first time a kernel
is launched on a CUDA tensor."""
