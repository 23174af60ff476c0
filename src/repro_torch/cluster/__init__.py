"""Cluster topology of the port (``topology.py``, a copy of the JAX
package's); the discrete-event simulator comes with the workload slice."""
