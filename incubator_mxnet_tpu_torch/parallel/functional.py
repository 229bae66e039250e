"""A Gluon block as a pure function of its parameter values (twin of
``incubator_mxnet_tpu/parallel/functional.py``):

    apply(params, states, inputs, rng, training)
        -> (outputs: list[Tensor], new_states: dict[str, Tensor])

with the block's current values split into trainable ``params`` and the
grad_req='null' ``states`` (BatchNorm's moving stats, the reference's
auxiliary states), each a dict keyed by the Gluon names, sorted.  It is
built on ``torch.func.functional_call`` over the block's torch
parameters; the live Parameters are left as they were.
"""
import contextlib

import torch

from .. import autograd
from .. import random as _random

__all__ = ["functionalize", "PureBlock"]


class PureBlock:
    """A Gluon block lowered to a pure function plus its parameter
    dicts."""

    def __init__(self, block):
        params = block.collect_params()
        unset = [n for n, p in params.items() if not p._allocated()]
        if unset:
            raise ValueError(
                f"{len(unset)} parameters have no value yet ({unset[:3]}"
                "...): initialize the block, and pass an example input "
                "to functionalize() if shapes are deferred")
        self._block = block
        self._params = {n: params[n] for n in sorted(params.keys())}
        paths = {id(t): path for path, t in block.named_parameters()}
        # Gluon name -> the torch path functional_call substitutes
        self._paths = {n: paths[id(p._var)]
                       for n, p in self._params.items()}
        self.trainable_names = [n for n, p in self._params.items()
                                if p.grad_req != "null"]
        self.state_names = [n for n, p in self._params.items()
                            if p.grad_req == "null"]

    # ------------------------------------------------------------ values
    def params(self):
        """The trainable parameters' live tensors, by name."""
        return {n: self._params[n]._var for n in self.trainable_names}

    def states(self):
        """The states' live tensors, by name."""
        return {n: self._params[n]._var for n in self.state_names}

    def write_back(self, params=None, states=None):
        """Copy values into the live Parameters (in place)."""
        with torch.no_grad():
            for src in (params, states):
                for n, v in (src or {}).items():
                    var = self._params[n]._var
                    if v is not var:
                        var.copy_(v)

    # ------------------------------------------------------------ apply
    def apply(self, params, states, inputs, rng=None, training=True):
        """The block's forward with ``params`` and ``states`` in place of
        its own values; returns (outputs, new_states).  In training mode
        BatchNorm's new moving stats land in fresh copies of ``states``,
        never in the given tensors or the live ones.  ``rng`` (a
        ``torch.Generator``) is the source of the random masks."""
        merged = {self._paths[n]: v for n, v in params.items()}
        new_states = {n: s.clone() for n, s in states.items()}
        merged.update({self._paths[n]: s for n, s in new_states.items()})
        scope = _random.key_provider(rng) if rng is not None \
            else contextlib.nullcontext()
        with scope, autograd.torch_mode(training):
            outs = torch.func.functional_call(
                self._block, merged, tuple(inputs), tie_weights=True,
                strict=False)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        return outs, new_states


def functionalize(block, *example_args):
    """Settle deferred shapes with one forward on ``example_args``
    (``HybridBlock.infer_shape``: no gradient, training off), then
    return a :class:`PureBlock`."""
    if example_args:
        block.infer_shape(*example_args)
    return PureBlock(block)
