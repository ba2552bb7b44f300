"""Typed request errors of the serving stack.

Counterpart of ``ollama_operator_tpu/runtime/errors.py``. The HTTP layer
maps ``BadRequest`` to 400 and ``DeadlineExceeded`` to 503 with
``Retry-After`` (shed while queued) or 504 (cut off before a stream
started). Plain ``ValueError``s are not client errors: they surface as
500s, so a server fault is never reported as a bad request.
"""


class BadRequest(ValueError):
    """The request is malformed or unsatisfiable; client's fault (HTTP 400)."""


class DeadlineExceeded(RuntimeError):
    """A request ran out of wall-clock budget (``deadline_ms``).

    ``while_queued`` tells the two HTTP mappings apart: a request shed
    before it ever held a slot maps to 503 + ``Retry-After`` (the caller
    lost nothing and should retry elsewhere); a request cut off
    mid-generation ends with a terminal stream frame whose finish reason
    is ``timeout`` (partial output was already sent), or 504 before the
    stream started.
    """

    def __init__(self, msg: str, *, while_queued: bool, retry_after_s: int = 1):
        super().__init__(msg)
        self.while_queued = while_queued
        self.retry_after_s = retry_after_s
