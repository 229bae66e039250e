"""Symbol: the declarative graph (twin of
``incubator_mxnet_tpu/symbol/symbol.py``; ref:
python/mxnet/symbol/symbol.py, nnvm Symbol/Graph).

A Symbol is a list of (node, output-index) heads over a DAG whose nodes
are variables or registered ops of the port's ``ops.registry``.  Names,
listings and the JSON format are the JAX package's, so a graph built the
same way in either package serializes to the same string, and a file
written by either loads in the other.

Shape inference runs each op's own torch function on ``device="meta"``
tensors (shapes and dtypes, no data), after ``ops.shape_hooks`` has
filled the shapes of parameter inputs the caller left unknown.  A
variable made with ``Variable(shape=...)`` has that shape unless the
call gives another, as in MXNet (the JAX package ignores the
attribute).  An op that reads values cannot run there and fails
inference with the JAX package's ``ValueError``; no shape is guessed.

``bind``/``simple_bind`` make an ``Executor`` (``executor.py``), which
walks the graph calling each op's torch function.
"""
import ast
import json
import threading

import numpy as np
import torch

from ..base import torch_dtype
from ..ops.registry import OPS, get_op
from ..ops.shape_hooks import HOOKS

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "NameManager"]


class NameManager:
    """Auto-naming for anonymous ops (ref: python/mxnet/name.py).  An
    active ``name.NameManager``/``Prefix`` scope overrides the
    process-global counters."""

    _lock = threading.Lock()
    _counters = {}

    @classmethod
    def next_name(cls, prefix):
        from .. import name as name_mod
        mgr = name_mod.current()
        if mgr is not None:
            return mgr.get(None, prefix)
        prefix = prefix.lower().lstrip("_")
        with cls._lock:
            idx = cls._counters.get(prefix, 0)
            cls._counters[prefix] = idx + 1
        return f"{prefix}{idx}"

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._counters = {}


class _Node:
    """Graph node: op is None for variables."""

    __slots__ = ("op", "name", "inputs", "params", "attrs")

    def __init__(self, op, name, inputs=(), params=None, attrs=None):
        self.op = op
        self.name = name
        self.inputs = list(inputs)   # [(Node, out_index)]
        self.params = dict(params or {})
        self.attrs = dict(attrs or {})

    @property
    def is_variable(self):
        return self.op is None

    @property
    def is_aux(self):
        return self.attrs.get("__is_aux__") == "1"

    def n_outputs(self):
        return 1 if self.op is None else self.op.n_outputs(self.params)


def _topo(heads):
    """Topological order of all nodes reachable from head entries."""
    order, seen = [], set()
    stack = [(h[0], False) for h in reversed(heads)]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        for inp, _ in reversed(node.inputs):
            if id(inp) not in seen:
                stack.append((inp, False))
    return order


def _var_dtype(node):
    return torch_dtype(node.attrs.get("__dtype__", "float32"))


def _np_dtype(dtype):
    """A torch dtype as numpy's (bfloat16, which numpy lacks, stays a
    torch dtype, as ``NDArray.dtype`` has it)."""
    if dtype == torch.bfloat16:
        return dtype
    return torch.empty((), dtype=dtype).numpy().dtype


class Symbol:
    """Handle to one or more output entries of a graph."""

    def __init__(self, heads):
        self._heads = list(heads)  # [(Node, out_idx)]

    # -------------------------------------------------------------- info
    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def __repr__(self):
        return f"<Symbol {self.name or [h[0].name for h in self._heads]}>"

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        for i in range(len(self._heads)):
            yield self[i]

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError(f"no output named {index}; have {names}")
            index = names.index(index)
        return Symbol([self._heads[index]])

    def __call__(self, *args, **kwargs):
        raise NotImplementedError("Symbol composition via call is not "
                                  "supported; compose via op functions")

    # -------------------------------------------------------------- listing
    def list_arguments(self):
        return [n.name for n in _topo(self._heads)
                if n.is_variable and not n.is_aux]

    def list_outputs(self):
        out = []
        for node, idx in self._heads:
            if node.is_variable:
                out.append(node.name)
            elif node.n_outputs() == 1:
                out.append(node.name + "_output")
            else:
                out.append(f"{node.name}_output{idx}")
        return out

    def list_auxiliary_states(self):
        return [n.name for n in _topo(self._heads)
                if n.is_variable and n.is_aux]

    def list_inputs(self):
        return [n.name for n in _topo(self._heads) if n.is_variable]

    def get_internals(self):
        """Symbol exposing every internal output entry."""
        heads = []
        for n in _topo(self._heads):
            for i in range(n.n_outputs()):
                heads.append((n, i))
        return Symbol(heads)

    def get_children(self):
        kids = []
        for node, _ in self._heads:
            kids.extend(node.inputs)
        return Symbol(kids) if kids else None

    # -------------------------------------------------------------- attrs
    def attr(self, key):
        if len(self._heads) == 1:
            return self._heads[0][0].attrs.get(key)
        return None

    def _set_attr(self, **kwargs):
        for node, _ in self._heads:
            node.attrs.update(  # graph-ok: the graph's own module
                {k: str(v) for k, v in kwargs.items()})

    def attr_dict(self):
        out = {}
        for n in _topo(self._heads):
            if n.attrs:
                out[n.name] = dict(n.attrs)
        return out

    # -------------------------------------------------------------- compose
    def _entry(self):
        if len(self._heads) != 1:
            raise ValueError("operation requires a single-output symbol")
        return self._heads[0]

    def _binary(self, opname, scalar_opname, other):
        if isinstance(other, Symbol):
            return _invoke(get_op(opname), [self, other], {})
        return _invoke(get_op(scalar_opname), [self], {"scalar": other})

    def __add__(self, o):
        return self._binary("broadcast_add", "_plus_scalar", o)
    __radd__ = __add__

    def __sub__(self, o):
        return self._binary("broadcast_sub", "_minus_scalar", o)

    def __rsub__(self, o):
        return _invoke(get_op("_rminus_scalar"), [self], {"scalar": o})

    def __mul__(self, o):
        return self._binary("broadcast_mul", "_mul_scalar", o)
    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary("broadcast_div", "_div_scalar", o)

    def __rtruediv__(self, o):
        return _invoke(get_op("_rdiv_scalar"), [self], {"scalar": o})

    def __pow__(self, o):
        return self._binary("broadcast_power", "_power_scalar", o)

    def __neg__(self):
        return _invoke(get_op("negative"), [self], {})

    def __getattr__(self, item):
        # method-style op calls: sym_instance.reshape(...), .sum(), ...
        if item.startswith("_"):
            raise AttributeError(item)
        op = OPS.get(item) or OPS.get({"reshape": "Reshape",
                                       "flatten": "Flatten"}.get(item, ""))
        if op is None:
            raise AttributeError(item)

        def method(*args, **kwargs):
            return _invoke(op, [self] + [a for a in args
                                         if isinstance(a, Symbol)],
                           {k: v for k, v in kwargs.items()
                            if not isinstance(v, Symbol)})
        return method

    # -------------------------------------------------------------- infer
    def infer_shape(self, *args, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes); raises when an
        argument's shape stays unknown."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As ``infer_shape``, with None where a shape stays unknown."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known = {}
        if args:
            for name, s in zip(self.list_arguments(), args):
                if s is not None:
                    known[name] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})

        order = _topo(self._heads)
        for node in order:      # Variable(shape=...): MXNet's rule
            if node.is_variable and node.name not in known \
                    and "__shape__" in node.attrs:
                known[node.name] = tuple(
                    ast.literal_eval(node.attrs["__shape__"]))
        shapes, dtypes = {}, {}   # (id(node), idx) -> shape / torch dtype
        for node in order:
            if node.is_variable:
                if node.name in known:
                    shapes[(id(node), 0)] = known[node.name]
                    dtypes[(id(node), 0)] = _var_dtype(node)
                continue
            in_keys = [(id(n), i) for n, i in node.inputs]
            in_shapes = [shapes.get(k) for k in in_keys]
            hookfn = HOOKS.get(node.op.name)
            if hookfn and any(s is None for s in in_shapes):
                filled = hookfn(in_shapes, node.params)
                for (inode, _), s_old, s_new in zip(
                        node.inputs, in_shapes, filled):
                    if s_old is None and s_new is not None \
                            and inode.is_variable:
                        shapes[(id(inode), 0)] = tuple(s_new)
                        dtypes[(id(inode), 0)] = _var_dtype(inode)
                in_shapes = [shapes.get(k) for k in in_keys]
            if any(s is None for s in in_shapes):
                continue  # leave outputs unknown
            outs = _meta_run(node, in_shapes,
                             [dtypes.get(k, torch.float32)
                              for k in in_keys])
            for i, o in enumerate(outs):
                shapes[(id(node), i)] = tuple(o.shape)
                dtypes[(id(node), i)] = o.dtype

        by_name = {n.name: n for n in order if n.is_variable}

        def _get(name_list):
            return [shapes.get((id(by_name[nm]), 0)) for nm in name_list]

        arg_shapes = _get(self.list_arguments())
        aux_shapes = _get(self.list_auxiliary_states())
        out_shapes = [shapes.get((id(n), i)) for n, i in self._heads]
        if not partial:
            missing = [nm for nm, s in zip(self.list_arguments(),
                                           arg_shapes) if s is None]
            if missing:
                raise ValueError(
                    f"infer_shape incomplete; unknown shapes for "
                    f"arguments {missing} — provide input shapes")
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """The JAX package's dtype inference: float32 unless a variable's
        ``__dtype__`` attribute says otherwise; outputs float32."""
        order = _topo(self._heads)
        args_d = [_np_dtype(_var_dtype(n)) for n in order
                  if n.is_variable and not n.is_aux]
        outs = [np.dtype("float32")] * len(self._heads)
        auxs = [_np_dtype(_var_dtype(n)) for n in order
                if n.is_variable and n.is_aux]
        return args_d, outs, auxs

    # -------------------------------------------------------------- grad
    def gradient(self, wrt):
        raise NotImplementedError(
            "use Executor.backward (whole-graph vjp) instead of "
            "symbolic gradient graphs")

    # -------------------------------------------------------------- json
    def tojson(self):
        """Serialize the graph in the JAX package's schema (the
        reference's nnvm JSON: nodes/arg_nodes/heads), framework tag
        included, so both packages write the same string."""
        order = _topo(self._heads)
        ids = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            entry = {
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "inputs": [[ids[id(inode)], iidx, 0]
                           for inode, iidx in n.inputs],
            }
            attrs = {}
            if n.params:
                attrs.update({k: repr(v) for k, v in n.params.items()})
            if n.attrs:
                attrs.update({f"__attr_{k}__" if not k.startswith("__")
                              else k: str(v) for k, v in n.attrs.items()})
            if attrs:
                entry["attrs"] = attrs
            nodes.append(entry)
        payload = {
            "nodes": nodes,
            "arg_nodes": [ids[id(n)] for n in order if n.is_variable],
            "heads": [[ids[id(n)], i, 0] for n, i in self._heads],
            "attrs": {"framework": "incubator_mxnet_tpu",
                      "version": "0.1.0"},
        }
        return json.dumps(payload, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -------------------------------------------------------------- opt
    def optimize(self, level=None, pass_names=None):
        """The graph-pass pipeline (``graph/``) is not ported yet
        (ROADMAP item A7), so this raises.  Binding is unaffected: the
        JAX package's level-1 passes preserve every output bit for bit
        (its ``graph/passes.py``), so the port's executor, which runs
        the graph as written, gives the outputs an optimized graph
        would."""
        raise NotImplementedError(
            "Symbol.optimize needs the graph-pass pipeline (graph/), "
            "which the port does not have yet (ROADMAP item A7)")

    # -------------------------------------------------------------- bind
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, **kwargs):
        from ..executor import Executor
        return Executor._simple_bind(self, ctx, grad_req, type_dict,
                                     kwargs, group2ctx=group2ctx)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        shared_exec=shared_exec, group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        return self.bind(ctx, kwargs).forward()

    def get_backend_symbol(self, backend):
        return self


def _meta_run(node, in_shapes, in_dtypes):
    """The outputs of ``node``'s op on meta tensors of the given shapes
    and dtypes (inference mode, no random draws)."""
    xs = [torch.empty(s, dtype=dt, device="meta")
          for s, dt in zip(in_shapes, in_dtypes)]
    params = dict(node.params)
    op = node.op
    if "ctx" in op.param_defaults:
        params["ctx"] = torch.device("meta")
    if op.needs_mode:
        params["_training"] = False
    if op.needs_rng:
        params["_rng"] = None
    try:
        with torch.no_grad():
            out = op.fn(*xs, **params)
    except Exception as e:
        raise ValueError(
            f"shape inference failed at op '{op.name}' (node "
            f"'{node.name}') with input shapes {in_shapes}: {e}") from None
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _invoke(op, sym_args, params, name=None):
    """Create a graph node from symbolic inputs; auto-create variables
    for missing parameter/aux inputs (``fc1_weight`` ...).  ``None``
    entries in sym_args are interior gaps (an input given by keyword
    with an earlier slot omitted), auto-created in place."""
    from ..attribute import current_attrs
    name = name or NameManager.next_name(op.name)
    scope_attrs = current_attrs()
    inputs = [None if s is None else s._entry() for s in sym_args]
    if not op.variadic:
        needed = list(op.arg_names) + list(op.aux_names)
        no_bias = params.get(
            "no_bias", op.param_defaults.get("no_bias", False))
        filled = []
        for i, argname in enumerate(needed):
            is_aux = i >= len(op.arg_names)
            given = inputs[i] if i < len(inputs) else None
            if given is None:
                if argname == "bias" and no_bias:
                    continue
                # auto-created weights inherit the active AttrScope
                attrs = dict(scope_attrs)
                if is_aux:
                    attrs["__is_aux__"] = "1"
                filled.append(
                    (_Node(None,  # graph-ok: the graph's own module
                           f"{name}_{argname}", attrs=attrs), 0))
            else:
                # explicitly passed variables in aux slots are tagged
                # too (export passes the moving stats as Variables)
                if is_aux and given[0].is_variable:
                    given[0].attrs["__is_aux__"] = "1"  # graph-ok: builder
                filled.append(given)
        filled.extend(inputs[len(needed):])   # over-provided: keep
        inputs = filled
    node = _Node(op, name, inputs, params,  # graph-ok: the graph's own module
                 attrs=scope_attrs or None)
    return Symbol([(node, i) for i in range(node.n_outputs())]
                  if node.n_outputs() > 1 else [(node, 0)])


def Variable(name, attr=None, shape=None, dtype=None, init=None, **kwargs):
    """Create a variable symbol."""
    from ..attribute import current_attrs
    attrs = current_attrs(attr)
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else \
            init.dumps() if hasattr(init, "dumps") else str(init)
    for k, v in kwargs.items():
        attrs[f"__{k}__"] = str(v)
    node = _Node(None, name, attrs=attrs)  # graph-ok: builder
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def load_json(json_str):
    payload = json.loads(json_str)
    nodes = []
    for entry in payload["nodes"]:
        params, attrs = {}, {}
        for k, v in entry.get("attrs", {}).items():
            if k.startswith("__attr_") and k.endswith("__"):
                attrs[k[len("__attr_"):-2]] = v
            elif k.startswith("__") and k.endswith("__"):
                attrs[k] = v
            else:
                try:
                    params[k] = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    params[k] = v
        if entry["op"] == "null":
            node = _Node(  # graph-ok: builder
                None, entry["name"], attrs=attrs)
        else:
            op = get_op(entry["op"])
            inputs = [(nodes[i], idx) for i, idx, _ in entry["inputs"]]
            node = _Node(  # graph-ok: the graph's own module
                op, entry["name"], inputs, params, attrs)
        nodes.append(node)
    heads = [(nodes[i], idx) for i, idx, _ in payload["heads"]]
    return Symbol(heads)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())
