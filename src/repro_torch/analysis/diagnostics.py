"""The analysis passes' diagnostic vocabulary.

Every diagnostic the v4 analysis emits carries one of these machine-readable
codes in :attr:`repro.core.compile.Diagnostic.code` (the validate stage's
own diagnostics keep an empty code).  Severities follow the compile
pipeline's rule: errors raise :class:`~repro.core.compile.CompileError`,
warnings ride on the product.

``over-budget``              (warning) a chain's derived worst-case cold-path
                             cost exceeds the block's ``cost: budget``.
``budget-bound-colocation``  (warning) a tag's affinity group cannot stay
                             warm-co-resident at the analysed concurrency on
                             any admissible worker — the keep-alive budget
                             (or worker memory) binds, so the affinity terms
                             degrade into a cold-start floor at runtime.
``unplaceable-chain``        (error) the bounded configuration-space search
                             proved no placement of the tag's chain exists
                             under the combined affinity + anti-affinity +
                             zone + memory constraints.
``ir-version``               (error) a consumer pinned to a different IR
                             version rejected the compiled product
                             (:func:`repro.core.compile.require_ir`).
"""
from __future__ import annotations

CODE_OVER_BUDGET = "over-budget"
CODE_BUDGET_COLOCATION = "budget-bound-colocation"
CODE_UNPLACEABLE = "unplaceable-chain"
CODE_IR_VERSION = "ir-version"
