"""Name scopes for symbol auto-naming (twin of
``incubator_mxnet_tpu/name.py``; ref: python/mxnet/name.py —
NameManager/Prefix).

``with mt.name.Prefix("stage1_"):`` prefixes every auto-generated
symbol name created in the scope; a plain ``NameManager`` scope gives
a fresh counter namespace (reproducible graph JSON in tests).  Outside
any scope, naming falls back to the process-global counters in
``symbol.NameManager``.  The names come out as the JAX package's
(``fullyconnected0``, ``stage1_convolution0``), so a graph built the
same way in either package serializes to the same JSON.
"""
import threading

__all__ = ["NameManager", "Prefix", "current"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


class NameManager:
    """Scoped auto-namer: each instance owns its own counters."""

    def __init__(self):
        self._counters = {}

    def get(self, name, hint):
        """Explicit ``name`` wins; otherwise generate ``hint<N>``."""
        if name:
            return name
        hint = hint.lower().lstrip("_")
        idx = self._counters.get(hint, 0)
        self._counters[hint] = idx + 1
        return f"{hint}{idx}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


class Prefix(NameManager):
    """NameManager that prepends a fixed prefix."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        if name:
            return name
        return self._prefix + super().get(None, hint)


def current():
    """The innermost active manager, or None (the global counters)."""
    stack = _stack()
    return stack[-1] if stack else None
