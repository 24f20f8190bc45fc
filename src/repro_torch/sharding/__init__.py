"""Sharding rules and the mesh context of the multi-device path
(``repro_torch.sharding.rules``)."""
