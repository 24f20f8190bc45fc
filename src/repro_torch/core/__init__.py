"""Consistent-hash engines: scalar oracles (``binomial``, ``jump``,
``memento``, ``registry``), the torch tensor versions of the device lookup
(``*_torch``) and the fleet-state protocol (``bulk``)."""
