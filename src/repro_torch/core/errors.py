"""Typed error taxonomy raised by the evaluator.

Every boundary — IR construction, config resolution, the sweep, the
grouping search — raises one of the classes below.  Each concrete class
also inherits the builtin exception raised at that boundary before the
taxonomy existed (``ValueError`` for validation and search failures,
``ArithmeticError`` for poisoned sweeps), so ``except ValueError`` call
sites keep working while new code can catch :class:`EvaluatorError`.

Taxonomy (the part this package raises)::

    EvaluatorError                      # root
    +-- GraphValidationError            # malformed GraphIR / LayerSpec / EdgeSpec
    +-- UnsupportedOpError              # an input the IR cannot express
    +-- ConfigValidationError           # bad DLAConfig / config-space request
    +-- InfeasibleBudgetError           # SRAM budget rejects every candidate
    |     .min_feasible_budget_words    #   smallest budget that would admit one
    +-- InfeasibleConstraintsError      # no swept candidate meets Constraints
    +-- SearchDeclined                  # a search engine refused the instance
    +-- PoisonedResultError             # every candidate of a graph was
                                        #   quarantined (NaN/Inf/negative/
                                        #   overflowed cost rows)
"""
from __future__ import annotations


class EvaluatorError(Exception):
    """Root of every typed failure the evaluator can report."""


class GraphValidationError(EvaluatorError, ValueError):
    """A graph/layer/edge violates the IR invariants (non-positive or
    non-integer dims, edge endpoints out of range, a non-topological edge —
    i.e. a cycle — or a duplicate edge).  The message names the offending
    node or edge."""


class UnsupportedOpError(EvaluatorError, ValueError):
    """An input cannot be lowered onto the paper's layer abstraction (for
    example an unknown VGG pooling mode)."""


class ConfigValidationError(EvaluatorError, ValueError):
    """A hardware configuration or config-space request is malformed
    (unknown style / SRAM-split preset, non-positive PE factors, a config
    space with heterogeneous area constants)."""


class InfeasibleBudgetError(EvaluatorError, ValueError):
    """The SRAM budget rejects every offered grouping candidate.

    ``min_feasible_budget_words`` is the smallest budget under which at
    least one of the rejected candidates would have survived (NaN when the
    failing path cannot compute it cheaply).
    """

    def __init__(self, message: str,
                 min_feasible_budget_words: float = float("nan")):
        """Attach the smallest budget that would have admitted a plan."""
        super().__init__(message)
        self.min_feasible_budget_words = float(min_feasible_budget_words)


class InfeasibleConstraintsError(EvaluatorError, ValueError):
    """The sweep ran, but no (hardware x grouping) candidate meets the
    user constraints."""


class SearchDeclined(EvaluatorError, ValueError):
    """A search engine refused the instance (for example a DAG handed to
    the chain-only search of this package)."""


class PoisonedResultError(EvaluatorError, ArithmeticError):
    """Every candidate cell for a graph was quarantined by the finite
    guard (NaN/Inf, negative, or ``> 2**53`` raw cost rows), so no argmin
    can be taken.  Partial poisoning never raises — poisoned cells are
    excluded and reported in ``FlowResult.quarantine``.  ``quarantined``
    carries the per-cell provenance records."""

    def __init__(self, message: str, *, quarantined: tuple = ()):
        """Attach the quarantined-cell provenance records."""
        super().__init__(message)
        self.quarantined = tuple(quarantined)
