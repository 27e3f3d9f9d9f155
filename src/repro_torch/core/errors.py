"""Typed error taxonomy raised by the evaluator and the planning service.

Every boundary — IR construction, config resolution, the sweep, the
grouping search, service admission — raises one of the classes below, and
the service (:mod:`repro_torch.core.service`) turns them into typed
*responses*.  Each concrete class also inherits the builtin exception
raised at that boundary before the taxonomy existed (``ValueError`` for
validation and search failures, ``TimeoutError`` for deadlines,
``ArithmeticError`` for poisoned sweeps, ``IOError`` for a corrupt
journal), so ``except ValueError`` call sites keep working while new code
can catch :class:`EvaluatorError`.

Taxonomy::

    EvaluatorError                      # root
    +-- GraphValidationError            # malformed GraphIR / LayerSpec / EdgeSpec
    +-- UnsupportedOpError              # an input the IR cannot express
    +-- ConfigValidationError           # bad DLAConfig / config-space request
    +-- InfeasibleBudgetError           # SRAM budget rejects every candidate
    |     .min_feasible_budget_words    #   smallest budget that would admit one
    +-- InfeasibleConstraintsError      # no swept candidate meets Constraints
    +-- SearchDeclined                  # a search engine refused the instance
    |     +-- fusion.FrontierTooWide    #   (defined next to the DP it guards)
    +-- DeadlineExceeded                # request missed its wall-clock deadline
    +-- ServiceOverloaded               # queue-depth bound shed the request
    +-- TransientFailure                # retries exhausted on a transient fault
    +-- RequestCancelled                # caller cancelled; sweep stopped at a
    |                                   #   chunk boundary
    +-- AuditMismatch                   # online shadow audit: served plan
    |                                   #   diverged from the scalar oracle
    +-- PoisonedResultError             # every candidate of a graph was
    |                                   #   quarantined (NaN/Inf/negative/
    |                                   #   overflowed cost rows)
    +-- JournalCorrupt                  # write-ahead log failed verification

:class:`RetryPolicy` lives here too: the one retry/backoff implementation
shared by the service's request-level retries and the fleet sweep's
per-chunk salvage (typed :class:`EvaluatorError` = deterministic, never
retried; anything else = possibly transient, retried with exponential
backoff).  The class names, messages and the delay schedule are the JAX
reference's: the journal rebuilds an error from its type name.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable


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
    """A search engine refused the instance (e.g. the exact frontier DP's
    width/state caps tripped).  Dispatchers absorb this and fall back; it
    only escapes when the caller pinned a specific engine."""


class DeadlineExceeded(EvaluatorError, TimeoutError):
    """The request's wall-clock deadline expired before a plan (even the
    cheapest ladder rung) could be produced."""


class ServiceOverloaded(EvaluatorError):
    """The service's queue-depth bound shed this request instead of
    growing the queue unboundedly."""


class TransientFailure(EvaluatorError):
    """A transient fault (a failed launch, an injected sweep failure)
    persisted through the bounded retry-with-backoff.  ``cause`` keeps the
    last underlying exception; ``attempts`` how many tries were made."""

    def __init__(self, message: str, *, cause: BaseException | None = None,
                 attempts: int = 0):
        """Record the last underlying exception and the attempt count."""
        super().__init__(message)
        self.cause = cause
        self.attempts = int(attempts)


class RequestCancelled(EvaluatorError):
    """The caller cancelled this request.  Cancellation is cooperative: a
    request still queued is answered immediately; one inside a sweep stops
    at the next chunk boundary (:func:`repro_torch.core.flow.run_fleet`
    with ``hw_chunk``), never mid-sweep."""


class AuditMismatch(EvaluatorError):
    """The online shadow audit re-scored a served plan against the scalar
    oracle (``bandwidth_ref`` et al.) and the metrics diverged — the fast
    path produced a silently wrong answer, which must fail loudly."""


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


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff, shared service-wide.

    One implementation classifies faults for both the request path
    (:meth:`repro_torch.core.service.PlanningService._with_retries`) and
    the compute path (per-chunk salvage in
    :func:`repro_torch.core.flow.run_fleet`): a typed
    :class:`EvaluatorError` is deterministic — retrying cannot change the
    answer — so it propagates immediately; any other exception is treated
    as transient and retried up to ``max_retries`` times, sleeping
    ``backoff_seconds * multiplier**attempt`` (capped at
    ``max_backoff_seconds``) between attempts.  Exhaustion raises
    :class:`TransientFailure` carrying the last cause and attempt count.
    """

    max_retries: int = 3
    backoff_seconds: float = 0.05
    multiplier: float = 2.0
    max_backoff_seconds: float = 5.0

    def __post_init__(self):
        """Validate the knobs at construction, not first use."""
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_seconds < 0:
            raise ValueError("backoff_seconds must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if self.max_backoff_seconds < 0:
            raise ValueError("max_backoff_seconds must be >= 0")

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based), capped."""
        return min(self.backoff_seconds * self.multiplier ** attempt,
                   self.max_backoff_seconds)

    def call(self, fn: Callable[[], Any], *,
             sleep: Callable[[float], None] = time.sleep,
             describe: str = "operation",
             on_retry: "Callable[[int, BaseException], None] | None" = None,
             ) -> Any:
        """Run ``fn`` under this policy and return its result.

        ``sleep`` is injectable so tests (and fault harnesses) can run
        with zero wall-clock cost; ``describe`` names the operation in
        the :class:`TransientFailure` message on exhaustion;
        ``on_retry(attempt, exc)`` fires on every caught transient (the
        service counts them).
        """
        last: BaseException | None = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except EvaluatorError:
                raise  # deterministic: retrying cannot change the answer
            except Exception as exc:  # noqa: BLE001 - transient boundary
                last = exc
                if on_retry is not None:
                    on_retry(attempt, exc)
                if attempt < self.max_retries:
                    delay = self.delay(attempt)
                    if delay > 0:
                        sleep(delay)
        raise TransientFailure(
            f"{describe} failed after {self.max_retries + 1} attempts "
            f"({type(last).__name__}: {last})",
            cause=last, attempts=self.max_retries + 1,
        )


class JournalCorrupt(EvaluatorError, IOError):
    """The write-ahead log failed verification beyond what crash-recovery
    tolerates: an interior record with a bad digest, a sequence gap, or a
    snapshot whose digest does not match.  (A *torn tail* — the final
    record cut mid-append — is normal crash damage and silently dropped.)
    Dual-inherits ``IOError`` like a checkpoint's corruption verdicts."""
