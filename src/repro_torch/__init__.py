"""PyTorch/CUDA port of the aAPP affinity-aware scheduler.

It mirrors the JAX package's layout (``core``, ``analysis``, ``platform``,
``kernels/affinity`` …) so each module's counterpart is easy to find, and
it imports neither JAX nor the JAX package: the framework-free modules are
copies.  Its entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``, where the kernels' plain PyTorch versions
run instead.
"""
