"""The multi-tenant serving controller (``engine.py``, a copy of the JAX
package's on the port's ``Platform``)."""
