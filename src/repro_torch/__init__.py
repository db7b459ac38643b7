"""PyTorch / CUDA port of the node-aware AMG solve (the JAX package
:mod:`repro` is the reference).

All D = ``n_pods × lanes`` ranks run in one process as a leading tensor dim;
collectives are index/transpose steps over that dim with the reference's
NAP message structure, and the local sparse products are hand-written CUDA
kernels for Hopper (:mod:`repro_torch.kernels.spmv`).  Entry points run on
the card unless the caller asks for ``device="cpu"``.
"""
