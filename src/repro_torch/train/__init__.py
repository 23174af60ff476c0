"""Step factories of the port: prefill and serve (decode).  The train step
comes with the training slice (``ROADMAP.md``)."""
