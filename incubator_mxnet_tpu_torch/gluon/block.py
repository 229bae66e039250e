"""Gluon Block / HybridBlock (twin of ``incubator_mxnet_tpu/gluon/block.py``),
as ``torch.nn.Module``s.

Names are the reference's, letter for letter: a block's prefix comes
from ``_BlockScope``'s global and per-scope counters (``dense0_``,
``resnetv10_stage1_``), and ``collect_params()`` keys are the
reference's for the same construction order.  Each Parameter a block's
ParameterDict hands out is registered on the block as a torch parameter
under the name it was asked for (``weight``, ``running_mean``), and each
child block is a torch submodule, so ``named_parameters``,
``state_dict``, ``.to()`` and ``torch.func.functional_call`` see the
whole tree.

``HybridBlock.forward`` runs ``hybrid_forward(F, x, **params)`` with
``F`` the port's ``nd`` module, as the reference's eager path does.  It
takes NDArrays or torch tensors and returns the kind it was given:

- NDArrays follow ``autograd``'s rules (recorded under ``record()``,
  training mode from ``record``/``train_mode``);
- torch tensors follow torch's: the call runs in
  ``autograd.torch_mode(self.training)``, so the ops keep torch's grad
  mode (the train step's ``functional_call``, a torch module holding
  Gluon layers) and training is the module's ``train()``/``eval()``.

Deferred shapes settle at the first forward through
``shape_from_input`` and ``Parameter._finish_deferred_init``.
``hybridize()`` routes ``__call__`` on NDArrays through a
``graph.CachedOp``: one entry per signature (input shapes, dtypes,
devices, static arguments, train flag), run through the graph-pass
pipeline when the block traces into a Symbol, and on a CUDA device
captured once as a CUDA graph and replayed after (see
``graph/cached_op.py``).  A hybridized block called on torch tensors,
in ``autograd.torch_mode`` or inside an outer CachedOp or capture runs
its forward directly.

Called on Symbols, a HybridBlock traces itself into a graph
(``_to_symbol``): its parameters become Variables named as the
parameters are, and ``hybrid_forward`` runs with ``F`` the ``sym``
module.  ``export`` writes that graph and the parameters in the JAX
package's checkpoint layout, and ``SymbolBlock`` runs a Symbol (one
written by either package) as a block.
"""
import logging
import re
import threading

import torch
from torch import nn

from .. import autograd
from .. import ndarray as _nd
from .. import symbol as _sym
from ..ndarray.ndarray import NDArray
from ..symbol.symbol import Symbol
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _InPlace)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_LOG = logging.getLogger(__name__)


class _BlockScope:
    """Name scoping for nested blocks."""

    _current = threading.local()
    _global_counter = {}

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                count = _BlockScope._global_counter.get(hint, 0)
                _BlockScope._global_counter[hint] = count + 1
                prefix = f"{hint}{count}_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, shared=params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix,
                                   shared=parent._shared)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        _BlockScope._current.value = self._old_scope


class Block(nn.Module):
    """Base building block: a torch module with the reference's names,
    parameters and children."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._params._block = self
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        # name asked for -> (torch attribute, Parameter), in order
        self._gluon_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def _register_param(self, name, param):
        """Make ``param``'s tensor this block's torch parameter
        ``name``."""
        attr = name.replace(".", "_")
        nn.Module.register_parameter(self, attr, param._var)
        self._gluon_params[name] = (attr, param)
        self._settled = False

    def _param(self, name):
        """The Parameter this block asked its ParameterDict for as
        ``name`` (``self.weight`` is its torch tensor)."""
        return self._gluon_params[name][1]

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            nn.Module.register_parameter(self, name, value._var)
            return
        super().__setattr__(name, value)

    def _child_blocks(self):
        return [m for m in self._modules.values() if isinstance(m, Block)]

    def collect_params(self, select=None):
        """All parameters of self and its descendants, as a
        ParameterDict; ``select`` keeps names the regex matches."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pattern.match(k)})
        for child in self._child_blocks():
            ret.update(child.collect_params(select))
        return ret

    def register_child(self, block):
        n = len(self._modules)
        while str(n) in self._modules:
            n += 1
        self.add_module(str(n), block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        for child in self._child_blocks():
            child.cast(dtype)
        for _, p in self.params.items():
            p.cast(dtype)

    def save_params(self, filename):
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra,
                                   restore_prefix=self.prefix)

    save_parameters = save_params
    load_parameters = load_params

    def hybridize(self, active=True):
        for child in self._child_blocks():
            child.hybridize(active)

    def infer_shape(self, *args):
        """Settle every deferred parameter shape with one forward on
        ``args`` (no gradient, inference mode)."""
        with torch.no_grad(), autograd.torch_mode(False):
            self(*args)

    def forward(self, *args):
        raise NotImplementedError

    def __repr__(self):
        return f"{self.__class__.__name__}({self._name})"


def _to_nd(a):
    return NDArray(a) if isinstance(a, torch.Tensor) else a


def _to_torch(out):
    if isinstance(out, NDArray):
        return out._data
    if isinstance(out, (list, tuple)):
        return type(out)(_to_torch(o) for o in out)
    return out


class HybridBlock(Block):
    """A block whose computation is ``hybrid_forward(F, x, **params)``.

    ``hybridize()`` swaps ``__call__`` onto a ``graph.CachedOp``: the
    forward is traced once per signature (through the pass pipeline
    when the block traces into a Symbol, else the eager forward) and,
    on a CUDA device, captured once as a CUDA graph and replayed on
    every later call with that signature.
    """

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._settled = False
        self._active = False
        self._cached_op = None
        self._cache_fallback = False

    def hybridize(self, active=True):
        self._active = active
        self._cached_op = None
        self._cache_fallback = False
        super().hybridize(active)

    def cast(self, dtype):
        self._cached_op = None
        super().cast(dtype)

    def __call__(self, *args, **kwargs):
        if not self._active or kwargs or not args \
                or not self._cacheable(args):
            return super().__call__(*args, **kwargs)
        return self._call_cached(*args)

    @staticmethod
    def _cacheable(args):
        """False for Symbols, torch tensors, torch_mode, and calls inside
        an outer CachedOp trace or a CUDA graph capture: those run the
        forward directly."""
        from ..graph.cached_op import in_trace
        if in_trace() or autograd.in_torch_mode():
            return False
        if any(isinstance(a, (Symbol, torch.Tensor)) for a in args):
            return False
        return not (torch.cuda.is_initialized()
                    and torch.cuda.is_current_stream_capturing())

    def _trace_symbol(self, template):
        """Trace this block into a Symbol graph for CachedOp's graph
        mode; returns ``(symbol, input_names)``.  Tensor argument slots
        become Variables ``data0``, ``data1``, ...; static arguments
        pass to ``hybrid_forward`` as their canonical values."""
        names = []

        def make_tensor(i):
            nm = f"data{i}"
            names.append(nm)
            return _sym.Variable(nm)

        out = self._to_symbol(*template.flat_args(make_tensor))
        if isinstance(out, (list, tuple)):
            out = _sym.Group(list(out))
        return out, names

    def _call_cached(self, *args):
        if self._cached_op is None:
            # settle deferred shapes: one eager forward lets each layer
            # infer its parameter shapes from its actual input
            from ..graph.cached_op import CachedOp, Inside
            if any(not p._allocated()
                   for p in self.collect_params().values()):
                with autograd.pause(), Inside():
                    super().__call__(*args)
            self._cached_op = CachedOp(self)
        from ..graph.cached_op import UnsupportedSignatureError
        try:
            return self._cached_op(*args)
        except UnsupportedSignatureError as exc:
            # this call cannot key the cache; later keyable calls still
            # hit it (warned once)
            if not self._cache_fallback:
                self._cache_fallback = True
                _LOG.warning("%s: arguments cannot key a replay cache "
                             "(%s); this call runs eagerly", self.name,
                             exc)
            return super().__call__(*args)

    def forward(self, *args, **kwargs):
        """``hybrid_forward`` on NDArrays (autograd's rules) or on torch
        tensors (torch's rules, training from ``self.training``);
        returns the kind it was given.  On Symbols it traces the block
        into a graph (``_to_symbol``)."""
        if args and isinstance(args[0], Symbol):
            return self._to_symbol(*args)
        nd_args = [NDArray(a) if isinstance(a, torch.Tensor) else a
                   for a in args]
        if all(a is b for a, b in zip(nd_args, args)):
            return self._forward_nd(args, kwargs)
        if kwargs:
            kwargs = {k: _to_nd(v) for k, v in kwargs.items()}
        if autograd.in_torch_mode():
            return _to_torch(self._forward_nd(nd_args, kwargs))
        with autograd.torch_mode(self.training):
            return _to_torch(self._forward_nd(nd_args, kwargs))

    def _forward_nd(self, args, kwargs):
        if not self._settled:
            self._finish_deferred(args)
        # _parameters, not getattr: functional_call substitutes there
        tensors = self._parameters
        params = {key: _InPlace(tensors[attr]) for key, attr in self._plan}
        return self.hybrid_forward(_nd, *args, **kwargs, **params)

    def _finish_deferred(self, args):
        """Infer deferred shapes from the inputs through the layer's
        ``shape_from_input``, then make and initialize those
        parameters."""
        own = [p for _, p in self._gluon_params.values()]
        if any(not p._allocated() for p in own):
            self.shape_from_input(*[a for a in args
                                    if isinstance(a, NDArray)])
            for p in own:
                p._finish_deferred_init()
        self._settled = all(p._allocated() for p in own)
        self._in_arity = len(args)          # export's input count
        # (hybrid_forward's name for it, its torch attribute)
        self._plan = [(key, attr)
                      for key, (attr, _) in self._gluon_params.items()]

    def shape_from_input(self, *inputs):
        """Layers with deferred parameters override this to set their
        shapes from the inputs."""
        raise DeferredInitializationError(
            f"{self.name}: parameter shapes unknown; construct with "
            "explicit in_units/in_channels or run initialize() after "
            "setting shapes")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _to_symbol(self, *sym_inputs):
        """Trace this block into a Symbol graph: its parameters become
        Variables of their names, and every layer's ``hybrid_forward``
        builds graph nodes through ``F = sym``."""
        params = {key: _sym.Variable(p.name)
                  for key, (_, p) in self._gluon_params.items()}
        return self.hybrid_forward(_sym, *sym_inputs, **params)

    def export(self, path, epoch=0):
        """Write the block as ``path-symbol.json`` and
        ``path-%04d.params`` (``arg:``/``aux:`` keys, CRC32 sidecar),
        the JAX package's layout, which ``symbol.load`` + Executor,
        ``Module.load`` and ``SymbolBlock.imports`` of either package
        read.  The block must have run a forward (shapes settled); its
        inputs are ``data`` (or ``data0``, ``data1``, ...)."""
        from ..model import save_checkpoint
        n = getattr(self, "_in_arity", 1)
        names = ["data"] if n == 1 else [f"data{i}" for i in range(n)]
        out = self._to_symbol(*[_sym.Variable(nm) for nm in names])
        if isinstance(out, (list, tuple)):
            out = _sym.Group(list(out))
        aux_names = set(out.list_auxiliary_states())
        arg, aux = {}, {}
        for name, p in self.collect_params().items():
            (aux if name in aux_names else arg)[name] = p.data()
        save_checkpoint(path, epoch, out, arg, aux)
        return out


class SymbolBlock(HybridBlock):
    """A Symbol and its parameters as a Block (ref: block.py
    SymbolBlock): every input of ``outputs`` that is not one of
    ``inputs`` becomes a parameter of that name (aux states with
    grad_req 'null'), and the forward runs the graph as the executor
    does, op by op, following autograd (or torch) like any block.  The
    aux states are not updated by a training-mode forward, as in the
    JAX package."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        if isinstance(outputs, (list, tuple)):
            outputs = _sym.Group(list(outputs))
        self._symbol = outputs
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        input_names = {i.name for i in self._inputs}
        aux = set(outputs.list_auxiliary_states())
        for name in outputs.list_inputs():
            if name not in input_names:
                self._params.get(name, allow_deferred_init=True,
                                 grad_req="null" if name in aux
                                 else "write")
        if params is not None:
            for name, v in params.items():
                if name in self._params.keys():
                    self._params[name].set_data(v)
        from ..executor import build_graph_fn
        self._graph_fn = build_graph_fn(outputs)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from ``symbol_file`` (JSON, of either package)
        and, if given, ``param_file`` (``.params``, its ``arg:``/``aux:``
        tags stripped) loaded onto ``ctx`` (None: the card)."""
        from ..model import split_tagged_params
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(_sym.load(symbol_file),
                            [_sym.Variable(n) for n in input_names])
        if param_file is not None:
            arg, aux = split_tagged_params(_nd.load(param_file, ctx=ctx))
            for name, v in {**arg, **aux}.items():
                if name in block._params.keys():
                    block._params[name].set_data(v)
        return block

    def _trace_symbol(self, template):
        """CachedOp's graph mode: the wrapped Symbol is the trace."""
        if not template.is_flat or len(template.tensor_nds) != \
                len(self._inputs):
            raise TypeError(
                f"{self.name}: expected {len(self._inputs)} tensor "
                "arguments for the wrapped symbol")
        return self._symbol, [i.name for i in self._inputs]

    def shape_from_input(self, *inputs):
        shapes = {i.name: a.shape for i, a in zip(self._inputs, inputs)}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape_partial(
            **shapes)
        known = dict(zip(self._symbol.list_arguments(), arg_shapes))
        known.update(zip(self._symbol.list_auxiliary_states(),
                         aux_shapes))
        for name, p in self._params.items():
            if known.get(name) is not None and not p._allocated():
                p.shape = known[name]

    def _forward_nd(self, args, kwargs):
        if not self._settled:
            self._finish_deferred(args)
        from ..executor import _next_seed
        tensors = self._parameters
        vals = {i.name: a._data for i, a in zip(self._inputs, args)}
        for key, attr in self._plan:
            vals[key] = tensors[attr]
        with autograd.grad_scope(list(vals.values())):
            outs, _ = self._graph_fn(vals, {}, _next_seed(),
                                     autograd.is_training())
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError
