"""Fleet-lifecycle types the routing datapath raises."""
