"""The invariant audit of the port's serving engines, counterpart of
``repro.analysis`` restated for eager PyTorch (the JAX package's HLO
parser and flop counter have no counterpart here):

* ``lint``  — AST source-invariant lint (standard library only);
* ``audit`` — the run-time checks over the engine matrix (``python -m
  repro_torch.analysis.audit``): state updated in place, no dense
  ``(S, cap, cap)`` allocation in a ring tick, the same op sequence every
  lifecycle, no host synchronisation, plus the lint.
"""
