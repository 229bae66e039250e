"""Deployment predict API (twin of ``incubator_mxnet_tpu/predictor.py``).

Python analog of the reference's C predict ABI (ref:
include/mxnet/c_predict_api.h — MXPredCreate:87, MXPredSetInput:177,
MXPredForward:191, MXPredGetOutput:160, MXPredReshape) serving a
``HybridBlock.export`` / ``Module.save_checkpoint`` artifact: symbol
JSON plus an arg:/aux: params file, bound once by ``simple_bind`` with
``grad_req='null'`` at the dtypes the params were saved at.
``ctx=None`` means the card (it raises on a host without one).
"""
import re

import numpy as np

from . import symbol as sym_mod
from .context import cpu
from .ndarray import ndarray as nd_mod
from .ndarray.ndarray import NDArray

__all__ = ["Predictor", "load_params", "serve"]


def load_params(param_file):
    """Split an exported params file into (arg_params, aux_params) of
    host arrays — same tag semantics as model.load_checkpoint
    (untagged keys count as args, unknown tags are ignored)."""
    from .model import split_tagged_params
    return split_tagged_params(nd_mod.load(param_file, ctx=cpu()))


def _strip_scope(name):
    """Drop one leading gluon name-scope prefix ('transformerlm0_'
    etc.) so params saved from one model instance load into another
    instance of the same architecture (whose auto-prefix counter
    differs)."""
    return re.sub(r"^[a-z]+\d+_(?=.)", "", name, count=1)


def _load_block_params(model, arg_params):
    """Load a saved param dict into a gluon Block by exact name,
    falling back to scope-prefix-stripped matching."""
    params = model.collect_params()
    by_suffix = {}
    for k in arg_params:
        by_suffix.setdefault(_strip_scope(k), k)
    missing = []
    for name, p in params.items():
        src = arg_params.get(name)
        if src is None:
            src = arg_params.get(by_suffix.get(_strip_scope(name)))
        if src is None:
            missing.append(name)
            continue
        p.set_data(src)
    if missing:
        raise IOError(
            f"parameters missing from the artifact: {missing} "
            f"(artifact keys: {sorted(arg_params)[:8]}...)")


def serve(param_file, model, **engine_kwargs):
    """Serving engine over an exported/checkpointed LM artifact.

    Loads ``param_file`` (saved via ``model.collect_params().save``
    or a checkpoint's ``arg:``-tagged params) into ``model`` — a
    ``TransformerLM`` instance matching the saved architecture — and
    returns a :class:`~incubator_mxnet_tpu_torch.serving.ServingEngine`
    over it (continuous batching + paged KV cache).  Engine kwargs (``max_batch``, ``quantize``,
    ...) pass through."""
    from .serving import ServingEngine
    arg_params, _aux = load_params(param_file)
    _load_block_params(model, arg_params)
    return ServingEngine(model, **engine_kwargs)


class Predictor:
    """Inference-only executor over an exported model.

    Parameters
    ----------
    symbol : path to ``*-symbol.json``, a JSON string, or a Symbol
    param_file : path to the ``*.params`` file (arg:/aux: keys)
    input_shapes : dict input name -> shape (incl. batch dim) — the
        reference's MXPredCreate input_keys/input_shape_* arrays
    ctx : Context (default: the card)
    """

    def __init__(self, symbol, param_file, input_shapes, ctx=None,
                 type_dict=None):
        if isinstance(symbol, sym_mod.Symbol):
            self._symbol = symbol
        elif str(symbol).lstrip().startswith("{"):
            self._symbol = sym_mod.load_json(symbol)
        else:
            self._symbol = sym_mod.load(symbol)
        self._ctx = ctx
        self._param_file = param_file
        arg_params, aux_params = load_params(param_file)
        shapes = dict(input_shapes)
        shapes.update({k: v.shape for k, v in arg_params.items()})
        # bind at the dtypes the model was trained/exported at (e.g.
        # bf16), not a silent float32 default; explicit type_dict wins
        td = {k: v.dtype
              for p in (arg_params, aux_params) for k, v in p.items()}
        td.update(type_dict or {})
        self._exec = self._symbol.simple_bind(
            self._ctx, grad_req="null", type_dict=td, **shapes)
        self._exec.copy_params_from(arg_params, aux_params,
                                    allow_extra_params=True)
        # positional predict() order = the caller's input_shapes
        # declaration order (dict order), NOT graph-topological order
        args = set(self._symbol.list_arguments())
        self._input_names = [n for n in input_shapes if n in args]
        self._inputs = {}
        self._outputs = None

    # ---------------------------------------------------------- C-api
    def set_input(self, name, value):
        """MXPredSetInput analog."""
        if name not in self._input_names:
            raise KeyError(
                f"'{name}' is not an input (inputs: "
                f"{self._input_names})")
        self._inputs[name] = value if isinstance(value, NDArray) \
            else nd_mod.array(np.asarray(value), ctx=cpu())

    @property
    def graph_report(self):
        """Graph-optimization report of the serving bind (per-pass
        node deltas)."""
        return self._exec.graph_report

    def forward(self, **inputs):
        """MXPredForward analog; inputs may also be passed directly."""
        for k, v in inputs.items():
            self.set_input(k, v)
        missing = [n for n in self._input_names
                   if n not in self._inputs]
        if missing:
            raise ValueError(f"inputs not set: {missing}")
        self._outputs = self._exec.forward(is_train=False,
                                           **self._inputs)
        return self._outputs

    def get_output(self, index=0):
        """MXPredGetOutput analog."""
        if self._outputs is None:
            raise RuntimeError("call forward() first")
        return self._outputs[index]

    def predict(self, *arrays):
        """Convenience: positional inputs -> first output's numpy."""
        if len(arrays) != len(self._input_names):
            raise ValueError(
                f"expected {len(self._input_names)} inputs "
                f"({self._input_names}), got {len(arrays)}")
        self.forward(**dict(zip(self._input_names, arrays)))
        return self.get_output(0).asnumpy()

    def reshape(self, input_shapes):
        """MXPredReshape analog: rebind for new input shapes (dtypes
        and parameters carry over via Executor.reshape)."""
        p = Predictor.__new__(Predictor)
        p._symbol = self._symbol
        p._ctx = self._ctx
        p._param_file = self._param_file
        p._exec = self._exec.reshape(**input_shapes)
        p._input_names = list(self._input_names)
        p._inputs = {}
        p._outputs = None
        return p

    def serve(self, model, **engine_kwargs):
        """Serving engine over this predictor's artifact — see
        module-level :func:`serve` (continuous batching + paged KV
        cache over the exported weights)."""
        return serve(self._param_file, model, **engine_kwargs)
