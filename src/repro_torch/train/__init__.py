"""Step factories of the port: train (loss, gradients, AdamW), prefill and
serve (decode)."""
