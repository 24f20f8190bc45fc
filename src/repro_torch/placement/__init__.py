"""Placement: the failure domain the serving router embeds (``elastic``),
assignment and movement accounting (``assignment``), and R-way replicated
store placement over the routing datapath (``store``)."""
