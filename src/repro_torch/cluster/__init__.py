"""Cluster topology and the discrete-event simulator of the port
(``topology.py``, ``simulator.py``, ``divide_impera.py``: copies of the JAX
package's)."""
