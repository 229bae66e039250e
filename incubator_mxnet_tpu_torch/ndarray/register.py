"""Generate the imperative op surface from the op registry (twin of
``incubator_mxnet_tpu/ndarray/register.py``).

Every registered OpDef becomes a function on the ``nd`` namespace;
names starting with '_' land on ``nd._internal``, as in MXNet.
"""
import types

from ..ops.registry import OPS


def make_nd_func(opname, op):
    from .ndarray import NDArray, imperative_invoke

    def f(*args, out=None, name=None, **kwargs):
        pos = list(args)
        # accept tensor inputs by keyword (data=..., lhs=..., ...)
        for an in op.arg_names[len(pos):]:
            if an in kwargs:
                pos.append(kwargs.pop(an))
            else:
                break
        # eager ops cannot create missing inputs, so an array kwarg
        # left behind a gap must fail loudly, not become a param
        leftover = [k for k, v in kwargs.items()
                    if isinstance(v, NDArray)]
        if leftover:
            missing = [n for n in op.arg_names[len(pos):]
                       if n not in kwargs]
            raise TypeError(
                f"nd.{opname}: array inputs {leftover} given by "
                f"keyword, but earlier inputs {missing} are missing "
                f"— eager ops need every input")
        return imperative_invoke(op, pos, kwargs, out)

    f.__name__ = opname
    f.__qualname__ = opname
    f.__doc__ = (op.doc or "") + "\n\n(generated from the op registry)"
    return f


def populate(nd_module):
    """Attach generated functions to the nd namespace module."""
    internal = types.ModuleType(nd_module.__name__ + "._internal")
    internal.__doc__ = "Internal (underscore) operators."
    for name, op in OPS.items():
        fn = make_nd_func(name, op)
        setattr(internal, name, fn)
        if not name.startswith("_") and not hasattr(nd_module, name):
            setattr(nd_module, name, fn)
    nd_module._internal = internal
    return internal
