"""The training step (twin of
``incubator_mxnet_tpu/parallel/data_parallel.py``), on one card.

``ShardedTrainStep`` runs forward, backward and the optimizer update
of a module for one batch: a plain torch module (``TransformerLM``),
whose parameters it updates in place, or a Gluon block (a
``HybridBlock`` or its ``PureBlock``), whose trainable parameters it
updates in place and whose states (BatchNorm's moving stats) it threads
from step to step in its own tensors as the JAX step does, until
``write_back()`` copies them into the live Parameters.  The step is the
forward (through the hand-written flash kernels for attention),
``torch.autograd.grad`` of the loss (the role of ``jax.value_and_grad``;
attention's gradient runs the backward kernels ``flash_dq`` and
``flash_dkv``), any ``grad_accum`` loop, and the multi-tensor optimizer
update.  Where the JAX step compiles one executable, this one, on a
CUDA device, is one CUDA graph replay (``_graph.StepGraph``), captured
once per batch signature: the parameters, optimizer state and states
are the graph's buffers, updated in place, and the learning rate is a
device tensor written before each replay.  On the CPU the same step runs
op by op.
"""
import contextlib

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from .. import random as _random
from ..gluon.block import Block
from . import _graph
from . import optim as foptim
from .functional import PureBlock, functionalize

__all__ = ["ShardedTrainStep"]


def _default_loss(outputs, labels):
    """Softmax cross-entropy on logits, averaged over every label."""
    logits = outputs[0].float()
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -picked.mean()


def _cast_floats(tree, dtype):
    """Cast the floating tensors of a ``{name: tensor}`` dict to
    ``dtype`` (integers untouched).  The cast is differentiable, so
    gradients reach the fp32 masters in fp32."""
    return {n: v.to(dtype) if v.is_floating_point() else v
            for n, v in tree.items()}


def _twin(gen):
    """A generator on ``gen``'s device in ``gen``'s state: remat's
    recomputed forward draws from it, so it draws the masks the first
    forward drew from ``gen``."""
    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


@contextlib.contextmanager
def _drawing_from(holder, gen):
    """Around remat's recomputed forward: its masks come from ``gen``
    (the twin), not from the step's generator."""
    was = holder[0]
    holder[0] = gen
    try:
        yield
    finally:
        holder[0] = was


class ShardedTrainStep:
    """One training step (forward, backward, optimizer update) of a
    module on the device its parameters live on.

    Parameters
    ----------
    block : torch.nn.Module (e.g. ``TransformerLM``), or a Gluon block
        or ``PureBlock`` (e.g. ``functionalize(resnet50_v1(), x)``)
    optimizer : str ('sgd', 'adam', 'nag') or a ``FunctionalOptimizer``
    optimizer_params : dict of the optimizer's hyper-parameters
    loss_fn : callable(outputs: list[Tensor], labels) -> 0-dim tensor;
        the block's output is wrapped in a list, as the JAX package's
        ``PureBlock.apply`` returns it.  Default: softmax cross-entropy.
    compute_dtype : if set (e.g. ``torch.bfloat16``), the forward and
        backward run in this dtype on casts of the fp32 parameters, and
        the fp32 masters receive fp32 gradients and the update (the
        reference's multi_precision / mp_sgd path).  A Gluon block's
        states are not cast.
    grad_accum : > 1 splits the batch into that many equal
        micro-batches; gradients and losses are summed and divided by
        ``grad_accum``, and a Gluon block's states pass through the
        micro-batches in order.
    remat : recompute the forward during the backward
        (``torch.utils.checkpoint``) instead of storing activations;
        the recomputed forward draws its dropout masks from a twin of
        the step's generator, set to the state the first forward drew
        from.
    lr_schedule : callable(step_count) -> lr, written into the step's
        learning-rate tensor before each step (``optim.warmup_cosine``
        / ``warmup_linear``).

    The parameters are the module's own fp32 ``nn.Parameter``s (the
    masters), updated in place.  ``trace_counts["train_step"]`` counts
    the CUDA graph captures (one per batch signature and generator).
    Not in this slice (the JAX step's
    ``mesh``, ``rules``, ``batch_axis`` / ``seq_axis``, ``zero``,
    ``donate``, ``example_args``, the memory preflight and OOM ladder,
    ``arm_perf`` / ``cost_analysis`` / ``memory_analysis`` and
    checkpoints): the multi-card modes come with the parallel-modes
    slice, the operability hooks with the operability slice.
    """

    def __init__(self, block, optimizer="sgd", optimizer_params=None,
                 loss_fn=None, compute_dtype=None, grad_accum=1,
                 remat=False, lr_schedule=None):
        if isinstance(block, Block):
            block = functionalize(block)
        self.pure = block if isinstance(block, PureBlock) else None
        self.block = block._block if self.pure is not None else block
        self.loss_fn = loss_fn or _default_loss
        if isinstance(optimizer, str):
            self.opt = foptim.create(optimizer,
                                     **(optimizer_params or {}))
        else:
            self.opt = optimizer
        self.compute_dtype = compute_dtype
        self.grad_accum = max(1, int(grad_accum))
        self.remat = bool(remat)
        self.lr_schedule = lr_schedule
        self.step_count = 0
        if self.pure is not None:
            self.params = self.pure.params()
            self.states = {n: s.clone()
                           for n, s in self.pure.states().items()}
        else:
            self.params = {n: p for n, p in block.named_parameters()
                           if p.requires_grad}
            self.states = {}
        if not self.params:
            raise ValueError("the block has no trainable parameters")
        self.device = next(iter(self.params.values())).device
        self.opt_state = self.opt.init(self.params)
        # the learning rate every update reads: written before each
        # step, so a captured graph follows the schedule
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._twins = {}     # remat: id(generator) -> (generator, twin)
        self.trace_counts = {}     # captures (the card), by name
        self._capture_gen = None   # the generator a capture draws from
        self._graph = _graph.StepGraph(
            lambda x, y: self._step(x, y, self._capture_gen),
            self._mutable, "train_step", self.trace_counts)

    # ------------------------------------------------------------ build
    def _batch(self, a):
        """A batch (tensor or array-like) on the parameters' device."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(self.device)

    def _forward(self, params, states, x, gens):
        """(outputs, new states) of the forward; its random masks come
        from ``gens[0]``."""
        if self.pure is not None:
            return self.pure.apply(params, states, [x], gens[0],
                                   training=True)
        with _random.key_provider(gens[0]):
            return torch.func.functional_call(self.block, params,
                                              (x,)), states

    def _grad_of(self, x, y, gen, states):
        """(loss, {name: fp32 gradient}, new states) of one
        (micro-)batch."""
        names = list(self.params)
        masters = list(self.params.values())
        params = self.params
        if self.compute_dtype is not None:
            params = _cast_floats(params, self.compute_dtype)
            if x.is_floating_point():
                x = x.to(self.compute_dtype)
        gens = [gen]
        if self.remat:
            twin = self._twins[id(gen)][1]
            out, states = _checkpoint.checkpoint(
                self._forward, params, states, x, gens,
                use_reentrant=False, preserve_rng_state=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    _drawing_from(gens, twin)))
        else:
            out, states = self._forward(params, states, x, gens)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        loss = self.loss_fn(outs, y)
        grads = torch.autograd.grad(loss, masters, allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, masters, grads)}, states

    def _step(self, x, y, gen):
        """The whole step on (x, y), in place: forward, backward, the
        ``grad_accum`` loop and the update; the states are written back
        into ``self.states``'s tensors.  Returns the loss."""
        accum = self.grad_accum
        if accum <= 1:
            loss, grads, states = self._grad_of(x, y, gen, self.states)
        else:
            grads, loss, states = None, None, self.states
            for xb, yb in zip(x.chunk(accum), y.chunk(accum)):
                lb, gb, states = self._grad_of(xb, yb, gen, states)
                if grads is None:
                    grads, loss = gb, lb
                else:
                    for n, g in gb.items():
                        grads[n].add_(g)
                    loss = loss + lb
            grads = {n: g / accum for n, g in grads.items()}
            loss = loss / accum
        self.opt.update(self.params, grads, self.opt_state, lr=self._lr)
        with torch.no_grad():
            for n, s in states.items():
                if s is not self.states[n]:
                    self.states[n].copy_(s)
        return loss

    def _mutable(self):
        """The tensors a step changes in place (a torch module's buffers
        too: a BatchNorm's running stats)."""
        buffers = list(self.block.buffers()) if self.pure is None else []
        return (list(self.params.values())
                + _graph.tensors_of(self.opt_state)
                + list(self.states.values()) + buffers)

    def _prepare(self, x, y, generator):
        """(x, y, generator, the generators the step draws from) for one
        step; writes this step's learning rate and syncs remat's twin."""
        x, y = self._batch(x), self._batch(y)
        accum = self.grad_accum
        if accum > 1 and x.shape[0] % accum != 0:
            raise ValueError(
                f"global batch {x.shape[0]} is not divisible by "
                f"grad_accum={accum}")
        gen = generator if generator is not None \
            else _random.default_generator(self.device)
        gens = [gen]
        if self.remat:
            if id(gen) not in self._twins:      # held: its id stays its
                self._twins[id(gen)] = (gen, _twin(gen))
            twin = self._twins[id(gen)][1]
            twin.set_state(gen.get_state())
            gens.append(twin)
        self._lr.fill_(self.lr_schedule(self.step_count)
                       if self.lr_schedule is not None
                       else self.opt.hyper["lr"])
        if self.pure is None:
            self.block.train()
        return x, y, gen, gens

    # -------------------------------------------------------------- run
    def __call__(self, x, y, generator=None):
        """One training step on the batch (x, y); returns the loss as a
        0-dim tensor on the device, without synchronizing (``float()``
        of it is the sync point).  ``generator`` (on the parameters'
        device) is the source of this step's dropout masks; default:
        the package's default generator for the device.

        On a CUDA device the step is one CUDA graph replay, captured at
        the first call with a new signature (``trace_counts``); on the
        CPU it runs eagerly."""
        if self.device.type != "cuda":
            return self._eager_call(x, y, generator)
        x, y, gen, gens = self._prepare(x, y, generator)
        self._capture_gen = gen     # read at a capture (one per generator)
        (loss,) = self._graph((x, y), gens)
        self.step_count += 1
        return loss

    step = __call__

    @property
    def capture_skipped(self):
        """The op that kept a batch signature from being captured (a
        ``Custom`` op in the net), or None: such a step runs eagerly on
        the card."""
        return self._graph.capture_skipped

    def _eager_call(self, x, y, generator=None):
        """The same step, op by op (no graph): the CPU's path, and on
        the card the yardstick a captured step is held against."""
        x, y, gen, _ = self._prepare(x, y, generator)
        loss = self._step(x, y, gen)
        self.step_count += 1
        return loss

    @torch.no_grad()
    def evaluate(self, x):
        """The block's forward on x in ``eval()`` mode (no dropout; a
        Gluon block with ``training=False`` on the step's states), as a
        list of outputs."""
        if self.pure is not None:
            return self.pure.apply(self.params, self.states,
                                   [self._batch(x)], training=False)[0]
        was_training = self.block.training
        self.block.eval()
        try:
            out = self.block(self._batch(x))
        finally:
            self.block.train(was_training)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def write_back(self):
        """Copy the step's values into the live parameters.  The
        trainable ones are the masters the step updates in place, so
        this copies a Gluon block's states (BatchNorm's moving stats);
        for a plain torch module it does nothing."""
        if self.pure is not None:
            self.pure.write_back(self.params, self.states)
