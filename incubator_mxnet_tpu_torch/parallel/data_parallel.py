"""The training step (twin of
``incubator_mxnet_tpu/parallel/data_parallel.py``), on one card.

``ShardedTrainStep`` runs forward, backward and the optimizer update
of a module for one batch.  PyTorch runs eagerly, so where the JAX step
compiles one executable, this one issues the same work op by op on the
module's device: the forward (through the hand-written flash kernels
for attention), ``torch.autograd.grad`` of the loss (the role of
``jax.value_and_grad``; attention's gradient runs the backward kernels
``flash_dq`` and ``flash_dkv``), and an in-place optimizer update.
"""
import contextlib

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from .. import random as _random
from . import optim as foptim

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


@contextlib.contextmanager
def _record(gen, saved):
    """Around the first forward under remat: note the generator state
    its random masks start from."""
    saved["state"] = gen.get_state()
    yield


@contextlib.contextmanager
def _replay(gen, saved):
    """Around the recomputed forward: draw the same masks again, then
    put the generator back where the step left it."""
    now = gen.get_state()
    gen.set_state(saved["state"])
    try:
        yield
    finally:
        gen.set_state(now)


class ShardedTrainStep:
    """One training step (forward, backward, optimizer update) of a
    module on the device its parameters live on.

    Parameters
    ----------
    block : torch.nn.Module (e.g. ``TransformerLM``)
    optimizer : str ('sgd', 'adam', 'nag') or a ``FunctionalOptimizer``
    optimizer_params : dict of the optimizer's hyper-parameters
    loss_fn : callable(outputs: list[Tensor], labels) -> 0-dim tensor;
        the block's output is wrapped in a list, as the JAX package's
        ``PureBlock.apply`` returns it.  Default: softmax cross-entropy.
    compute_dtype : if set (e.g. ``torch.bfloat16``), the forward and
        backward run in this dtype on casts of the fp32 parameters, and
        the fp32 masters receive fp32 gradients and the update (the
        reference's multi_precision / mp_sgd path).
    grad_accum : > 1 splits the batch into that many equal
        micro-batches; gradients and losses are summed and divided by
        ``grad_accum``.
    remat : recompute the forward during the backward
        (``torch.utils.checkpoint``) instead of storing activations;
        the dropout masks are drawn again from the same generator
        state.
    lr_schedule : callable(step_count) -> lr, passed to the update
        (``optim.warmup_cosine`` / ``warmup_linear``).

    The parameters are the module's own fp32 ``nn.Parameter``s (the
    masters), updated in place.  Not in this slice (the JAX step's
    ``mesh``, ``rules``, ``batch_axis`` / ``seq_axis``, ``zero``,
    ``donate``, ``example_args``, the memory preflight and OOM ladder,
    ``arm_perf`` / ``cost_analysis`` / ``memory_analysis`` and
    checkpoints): the multi-card modes come with the parallel-modes
    slice, the operability hooks with the operability slice.
    """

    def __init__(self, block, optimizer="sgd", optimizer_params=None,
                 loss_fn=None, compute_dtype=None, grad_accum=1,
                 remat=False, lr_schedule=None):
        self.block = block
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
        self.params = {n: p for n, p in block.named_parameters()
                       if p.requires_grad}
        if not self.params:
            raise ValueError("the block has no trainable parameters")
        self.device = next(iter(self.params.values())).device
        self.opt_state = self.opt.init(self.params)

    # ------------------------------------------------------------ build
    def _batch(self, a):
        """A batch (tensor or array-like) on the parameters' device."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(self.device)

    def _forward(self, params, x, gen):
        with _random.key_provider(gen):
            return torch.func.functional_call(self.block, params, (x,))

    def _grad_of(self, x, y, gen):
        """(loss, {name: fp32 gradient}) of one (micro-)batch."""
        names = list(self.params)
        masters = list(self.params.values())
        params = self.params
        if self.compute_dtype is not None:
            params = _cast_floats(params, self.compute_dtype)
            if x.is_floating_point():
                x = x.to(self.compute_dtype)
        if self.remat:
            saved = {}
            out = _checkpoint.checkpoint(
                self._forward, params, x, gen, use_reentrant=False,
                context_fn=lambda: (_record(gen, saved),
                                    _replay(gen, saved)))
        else:
            out = self._forward(params, x, gen)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        loss = self.loss_fn(outs, y)
        grads = torch.autograd.grad(loss, masters, allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, masters, grads)}

    # -------------------------------------------------------------- run
    def __call__(self, x, y, generator=None):
        """One training step on the batch (x, y); returns the loss as a
        0-dim tensor on the device, without synchronizing (``float()``
        of it is the sync point).  ``generator`` (on the parameters'
        device) is the source of this step's dropout masks; default:
        the package's default generator for the device."""
        x, y = self._batch(x), self._batch(y)
        accum = self.grad_accum
        if accum > 1 and x.shape[0] % accum != 0:
            raise ValueError(
                f"global batch {x.shape[0]} is not divisible by "
                f"grad_accum={accum}")
        gen = generator if generator is not None \
            else _random.default_generator(self.device)
        self.block.train()
        if accum <= 1:
            loss, grads = self._grad_of(x, y, gen)
        else:
            grads, loss = None, None
            for xb, yb in zip(x.chunk(accum), y.chunk(accum)):
                lb, gb = self._grad_of(xb, yb, gen)
                if grads is None:
                    grads, loss = gb, lb
                else:
                    for n, g in gb.items():
                        grads[n].add_(g)
                    loss = loss + lb
            grads = {n: g / accum for n, g in grads.items()}
            loss = loss / accum
        lr = self.lr_schedule(self.step_count) \
            if self.lr_schedule is not None else None
        self.opt.update(self.params, grads, self.opt_state, lr=lr)
        self.step_count += 1
        return loss

    step = __call__

    @torch.no_grad()
    def evaluate(self, x):
        """The block's forward on x in ``eval()`` mode (no dropout), as
        a list of outputs."""
        was_training = self.block.training
        self.block.eval()
        try:
            out = self.block(self._batch(x))
        finally:
            self.block.train(was_training)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def write_back(self):
        """A no-op: the module's parameters are the masters the step
        updates, so there is nothing to copy back.  Kept so that code
        written for the JAX step (which copies its mesh values back
        into the Gluon parameters) runs unchanged."""
