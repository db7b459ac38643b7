"""Local sparse kernels of the distributed solve: ELL SpMV, ELL SpMM and
block-ELL (BCSR) SpMM, as CUDA C++ for Hopper (``csrc/``) with ctypes
wrappers and plain PyTorch versions (:mod:`.ref`)."""
