"""Serving tier: the scalar control plane (``router``), the batched device
datapath (``batch_router``) and the session-movement store."""
