"""ERT micro-kernels for the roofline's measured ceilings: a streaming
FMA chain and a random gather, as CUDA C++ for Hopper (``csrc/ert.cu``)
with ctypes wrappers and plain PyTorch versions (:mod:`.ref`)."""
