"""Coded errors of the serving path (same class names, bases and
``error_code`` values as ``paddle_tpu/core/errors.py``)."""
from __future__ import annotations


class EnforceNotMet(RuntimeError):
    """Base of all framework errors. Every subclass carries a stable
    ``error_code`` so tooling and logs can match on code rather than
    message text."""

    error_code = "PDT-E000"  # LEGACY


class PageBudgetError(EnforceNotMet, ValueError):
    """A serving request can NEVER be satisfied by the engine's page
    pool: ``ceil((prompt + max_new_tokens) / page_size)`` exceeds the
    usable pool (``total_pages - 1``; page 0 is the reserved null page).
    Raised eagerly at ``ContinuousBatchingEngine.add_request``."""

    error_code = "PDT-E016"


class QueueFullError(EnforceNotMet):
    """``ContinuousBatchingEngine.add_request`` under the ``reject``
    admission policy: the bounded queue (``max_queue``) is full."""

    error_code = "PDT-E017"


class NonFiniteLogitsError(EnforceNotMet, FloatingPointError):
    """The serving decode guard found non-finite logits for ONE request.
    The engine fails only that request (``finish_reason == "failed"``,
    this error on ``CompletedRequest.error``); it is never raised
    through the engine loop."""

    error_code = "PDT-E018"


class CacheIntegrityError(EnforceNotMet):
    """The serving page allocator's conservation invariants broke (a
    double free, a page both free and referenced, the null page 0 in
    circulation, or in-use + free + cached no longer summing to the
    usable pool). An allocator bug, never a user error."""

    error_code = "PDT-E019"
