"""Analysis helpers of the port.  ``markers`` holds the constant-time
waiver marker (stdlib only), so that a paper-faithful baseline carries the
same reasoned waiver as in the JAX package; the certifier that reads it
is not ported yet."""
