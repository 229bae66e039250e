"""Generate the symbolic op surface from the op registry (twin of
``incubator_mxnet_tpu/symbol/register.py``, the mirror of
``ndarray/register.py``): every registered op becomes a function on
``sym`` (names starting with '_' on ``sym._internal``)."""
import types

from ..ops.registry import OPS
from .symbol import Symbol, _invoke


def make_sym_func(opname, op):
    def f(*args, name=None, attr=None, **kwargs):
        # trailing None positional inputs mean "absent optional input"
        # (a no-bias layer passes bias=None); an interior None would
        # shift later inputs into wrong slots, so it is rejected
        while args and args[-1] is None:
            args = args[:-1]
        if any(a is None for a in args):
            raise TypeError(
                f"sym.{opname}: only trailing optional inputs may be "
                "None; pass interior optional inputs by keyword")
        for a in args:
            if not isinstance(a, Symbol):
                raise TypeError(
                    f"sym.{opname} positional inputs must be Symbols, "
                    f"got {type(a).__name__}; for scalar operands use "
                    f"the *_scalar internal ops or Python operators "
                    f"(e.g. `x + 3`, sym._internal._maximum_scalar)")
        sym_args = list(args)
        if not op.variadic:
            # fill the remaining input slots from keywords; a missing
            # interior slot becomes a None gap that _invoke fills with
            # an auto-created variable (FullyConnected(x, bias=b) keeps
            # b in the bias slot)
            needed = list(op.arg_names) + list(op.aux_names)
            for an in needed[len(sym_args):]:
                if an in kwargs and isinstance(kwargs[an], Symbol):
                    sym_args.append(kwargs.pop(an))
                else:
                    sym_args.append(None)
            while sym_args and sym_args[-1] is None:
                sym_args.pop()
        leftover = [k for k, v in kwargs.items() if isinstance(v, Symbol)]
        if leftover:
            raise TypeError(
                f"sym.{opname}: {leftover} are not input slots of this "
                f"op (inputs: {list(op.arg_names)} + aux "
                f"{list(op.aux_names)})")
        params = {k: v for k, v in kwargs.items() if v is not None}
        out = _invoke(op, sym_args, params, name)
        if attr:
            out._set_attr(**attr)
        return out

    f.__name__ = opname
    f.__qualname__ = opname
    f.__doc__ = (op.doc or "") + "\n\n(generated symbolic wrapper)"
    return f


def populate(sym_module):
    internal = types.ModuleType(sym_module.__name__ + "._internal")
    internal.__doc__ = "Internal (underscore) symbolic operators."
    for name, op in OPS.items():
        fn = make_sym_func(name, op)
        setattr(internal, name, fn)
        if not name.startswith("_") and not hasattr(sym_module, name):
            setattr(sym_module, name, fn)
    sym_module._internal = internal
    return internal
