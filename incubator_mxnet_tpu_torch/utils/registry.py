"""Generic name -> object registry with aliases (twin of
``incubator_mxnet_tpu/utils/registry.py``; ref:
python/mxnet/registry.py): one source of truth from which a frontend
generates its surface (``metric.create``)."""

__all__ = ["Registry", "get_registry"]


class Registry:
    def __init__(self, kind):
        self.kind = kind
        self._entries = {}

    def register(self, name=None, obj=None, aliases=()):
        """Register ``obj`` under ``name``; usable as a decorator."""
        def _do(o, nm):
            nm = nm or getattr(o, "__name__", None)
            if nm is None:
                raise ValueError("registry entry needs a name")
            key = nm.lower()
            if key in self._entries and self._entries[key] is not o:
                raise ValueError(f"{self.kind} '{nm}' already registered")
            self._entries[key] = o
            for a in aliases:
                self._entries[a.lower()] = o
            return o
        if obj is not None:
            return _do(obj, name)
        if callable(name):  # bare decorator: @reg.register
            return _do(name, None)
        return lambda o: _do(o, name)

    def get(self, name):
        try:
            return self._entries[name.lower()]
        except KeyError:
            raise KeyError(f"unknown {self.kind} '{name}'; known: "
                           f"{sorted(self._entries)}") from None

    def find(self, name):
        return self._entries.get(name.lower())

    def __contains__(self, name):
        return name.lower() in self._entries

    def keys(self):
        return sorted(self._entries)


_REGISTRIES = {}


def get_registry(kind):
    if kind not in _REGISTRIES:
        _REGISTRIES[kind] = Registry(kind)
    return _REGISTRIES[kind]
