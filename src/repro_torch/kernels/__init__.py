"""Local kernels: the hand-written CUDA kernels (``csrc/``), their
wrappers and plain versions, and the static dispatch (``ops``)."""
