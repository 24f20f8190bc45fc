"""The plain reference the benchmark judges the port against.

Plain PyTorch and Python, frozen here: the lookup, the replacement-table
divert, the R-way resolve and the fleet's removed set and table rebuilt
from the event sequence.  Nothing here imports the port, JAX or the JAX
package, and nothing takes a table, a state or a weight the program made.
"""
