"""The routing datapath's CUDA kernels (``csrc/``), their build
(``build``), wrappers with plain versions and launch counts (``fused``) and
the spec-level entry points (``ops``)."""
