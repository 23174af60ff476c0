"""Roofline cost models: partitioned-HLO text (:mod:`.hlo`,
:func:`.flops.analyze`) and PyTorch's aten op stream
(:class:`.flops.OpCounter`)."""
