"""The port's CUDA kernels (``csrc/``: the routing datapath's in
``routing.cu``, the training path's in ``train.cu``), their build
(``build``), wrappers with plain versions and launch counts (``fused`` for
routing, ``train`` for training) and the spec-level entry points
(``ops``)."""
