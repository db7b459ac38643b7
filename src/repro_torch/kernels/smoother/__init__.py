"""The block smoothers' local updates: a block-diagonal apply
(block-Jacobi) and a sync-free sparse triangular solve (hybrid
Gauss-Seidel), as CUDA C++ for Hopper (``csrc/``) with ctypes wrappers and
plain PyTorch versions (:mod:`.ref`)."""
