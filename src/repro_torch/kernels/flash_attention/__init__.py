"""Causal GQA flash attention (online softmax, optional sliding window,
right-aligned queries) as CUDA C++ for Hopper (``csrc/``), with a ctypes
wrapper and its plain PyTorch version (:mod:`.ref`)."""
