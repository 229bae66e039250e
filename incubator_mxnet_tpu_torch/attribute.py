"""Attribute scopes (twin of ``incubator_mxnet_tpu/attribute.py``; ref:
python/mxnet/attribute.py — AttrScope).

``with mt.AttrScope(ctx_group="dev1", __lr_mult__="0.1"):`` attaches
the given attributes to every symbol created inside the scope,
auto-created weight variables included, merged over outer scopes with
the innermost winning.  This is how ``group2ctx`` placement and
per-layer tags reach the graph; the optimizer reads the dunder
spellings ``__lr_mult__``/``__wd_mult__``, as it does for
``Variable(lr_mult=...)``.
"""
import threading
import warnings

__all__ = ["AttrScope", "current_attrs"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


class AttrScope:
    """Scope attaching attributes to symbols created within."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if not isinstance(v, str):
                raise ValueError(
                    "AttrScope values must be strings "
                    f"(got {type(v).__name__})")
            if k in ("lr_mult", "wd_mult"):
                warnings.warn(
                    f"AttrScope({k}=...) is not read by the optimizer; "
                    f"use the dunder spelling __{k}__=... (reference "
                    "convention)", stacklevel=2)
        self._attr = kwargs

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


def current_attrs(attr=None):
    """Attributes from every active scope (outer -> inner), with the
    explicit ``attr`` dict winning over all scopes."""
    out = {}
    for scope in _stack():
        out.update(scope._attr)
    if attr:
        out.update(attr)
    return out
