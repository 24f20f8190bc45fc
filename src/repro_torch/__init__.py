"""BinomialHash routing datapath in PyTorch with hand-written CUDA kernels.

The counterpart of the JAX package ``repro``: same module names where they
help, plain functions on tensors, an explicit ``device``.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``, where the
kernels' plain torch versions run instead.  The kernels are compiled with
``nvcc`` at first use (``repro_torch.kernels.build``), never at import.

Main path: ``repro_torch.serving.batch_router.BatchRouter``.
"""
