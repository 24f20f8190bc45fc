"""Placement: the failure domain the serving router embeds."""
