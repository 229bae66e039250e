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

Before its first step the memory preflight plans the step
(``perf.memory_planner``: the parameters, gradients and optimizer state
from the real tensors, the activations from the aten ops the forward
dispatches on ``meta`` tensors) against the card's capacity, and under
``MXTPU_MEM_POLICY=degrade`` a predicted overflow walks the ladder:
remat, then the next divisor of the batch as ``grad_accum``, then a
typed ``MemoryPlanError``.  A step that runs out of memory anyway
(``torch.OutOfMemoryError``, during a step or its capture, or the
``mem:oom`` injection) becomes an ``OomError``: the step drops its
captured graphs and their memory pools, releases the allocator's cached
blocks, takes one rung and runs the batch once more; a second OOM
raises.  ``arm_perf`` / ``cost_analysis`` arm the MFU clock
(``perf.TrainPerfClock``, device time), ``memory_analysis`` returns the
planner's ``MemoryPlan``.
"""
import contextlib
import copy
import gc
import logging

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
    ``donate``, ``example_args`` and checkpoints): the multi-card modes
    come with the parallel-modes slice (ROADMAP item A9).
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
        self._graph = self._new_graph()
        # perf observatory: armed by cost_analysis()/arm_perf()
        self._perf_clock = None
        # memory planner: the preflight's accepted plan and the cached
        # forward liveness (planned once, never on the step path)
        self._mem_plan = None
        self._mem_liveness = None
        self._planned = False

    def _new_graph(self):
        return _graph.StepGraph(
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
        CPU it runs eagerly.  The first call runs the memory preflight;
        an out-of-memory step takes one rung of the ladder and runs
        once more."""
        from ..resilience import as_oom_error, check_oom
        for attempt in (0, 1):
            try:
                if not self._planned:
                    self._preflight(x, y)
                # mem:oom injection point; one env read without a spec
                check_oom("sharded_train_step")
                if self.device.type != "cuda":
                    loss = self._eager_call(x, y, generator)
                else:
                    xb, yb, gen, gens = self._prepare(x, y, generator)
                    # read at a capture (one per generator)
                    self._capture_gen = gen
                    (loss,) = self._graph((xb, yb), gens)
                    self.step_count += 1
                break
            except Exception as exc:
                oom = as_oom_error(exc, "sharded_train_step",
                                   plan=self._mem_plan)
                if oom is None:
                    raise
                if attempt or not self._oom_rung(x):
                    raise oom from exc
            # out of the handler, the failed attempt's frames are gone:
            # what they held can go back to the card before the retry
            self._release_graphs()
        if self._perf_clock is not None:
            self._perf_clock.tick()       # device events, no sync
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

    # ------------------------------------------------------ memory plan
    def _meta_args(self, x, y):
        meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        x, y = self._batch_meta(x), self._batch_meta(y)
        return ({n: meta(p).requires_grad_(p.requires_grad)
                 for n, p in self.params.items()},
                {n: meta(v) for n, v in self.states.items()}, x, y)

    def _batch_meta(self, a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return torch.empty(a.shape, dtype=a.dtype, device="meta")

    def _trace_liveness(self, x, y):
        """The activation term of the plan: ``dispatch_liveness`` of the
        forward loss on ``meta`` tensors (cached; never on the step
        path)."""
        if self._mem_liveness is not None:
            return
        from ..perf.memory_planner import dispatch_liveness
        cdt = self.compute_dtype

        def fwd(params, states, xa, ya):
            if cdt is not None:
                params = _cast_floats(params, cdt)
                if xa.is_floating_point():
                    xa = xa.to(cdt)
            out, _ = self._forward(params, states, xa, [None])
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            return self.loss_fn(outs, ya)

        self._mem_liveness = dispatch_liveness(
            fwd, *self._meta_args(x, y), data_args=(2, 3))

    def _memory_plan(self, remat, grad_accum):
        """The MemoryPlan of this step at the given knobs.  The step
        takes every gradient at once (``torch.autograd.grad``), so the
        working gradient is the whole trainable tree."""
        from ..perf import memory_planner as mp
        return mp.plan_memory(
            liveness=self._mem_liveness,
            params_bytes=mp.tree_bytes(self.params)
            + mp.tree_bytes(self.states),
            max_param_bytes=mp.tree_bytes(self.params),
            optimizer_bytes=mp.tree_bytes(self.opt_state),
            grad_accum=grad_accum, remat=remat, donate=True)

    def _preflight(self, x, y):
        """Plan the step before its first run; under
        MXTPU_MEM_POLICY=degrade a predicted overflow walks the ladder
        (remat -> next grad_accum divisor) and the step adopts the
        knobs that fit.  A dry ladder raises ``MemoryPlanError``; a
        planner that cannot trace the block logs it and plans nothing
        (the gate is a guard, not a dependency)."""
        from ..perf.memory_planner import plan_failed, preflight
        from ..resilience import MemoryPlanError
        self._planned = True
        try:
            self._trace_liveness(x, y)
            res = preflight(
                self._memory_plan, site="sharded_train_step",
                device=self.device, can_remat=True,
                batch_size=int(np.shape(x)[0]) if np.ndim(x) else 0,
                remat=self.remat, grad_accum=self.grad_accum)
        except MemoryPlanError:
            raise
        except Exception:
            plan_failed("sharded_train_step")
            return
        if res is not None:
            self.remat = res.remat
            self.grad_accum = res.grad_accum
            self._mem_plan = res.plan

    def _release_graphs(self):
        """Drop every captured graph and its memory pool, and hand the
        allocator's cached blocks back: what a rung does before the
        retry captures again."""
        self._graph = self._new_graph()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _oom_rung(self, x):
        """One runtime degrade rung after a real (or injected) OOM:
        remat, else the next divisor of the batch as grad_accum (the
        caller then drops the captured graphs, so the retry captures
        once more).  Returns False (the caller raises the OomError) when
        the ladder is dry or MXTPU_MEM_POLICY=off."""
        from .. import telemetry, tracing
        from ..perf.memory_planner import next_divisor
        from ..utils.env import get_env
        if str(get_env("MXTPU_MEM_POLICY")).lower() == "off":
            return False
        rung = None
        if not self.remat:
            self.remat, rung = True, "remat"
        else:
            nxt = next_divisor(int(np.shape(x)[0]), self.grad_accum)
            if nxt is not None:
                self.grad_accum, rung = nxt, f"grad_accum={nxt}"
        if rung is None:
            return False
        telemetry.counter("oom_retries_total").inc()
        tracing.trace_event("mem_degrade", site="sharded_train_step",
                            rung=rung, cause="runtime_oom")
        logging.getLogger("mxtpu.memory").warning(
            "OOM at sharded_train_step: degrade ladder rung '%s', "
            "retrying once%s", rung,
            " (numerics change: smaller micro-batches)"
            if rung.startswith("grad_accum") else
            " (numerics unchanged; more compute)")
        return True

    # ------------------------------------------------------------- perf
    def arm_perf(self, flops_per_step=0.0, bytes_per_step=0.0,
                 tokens_per_step=0.0, dtype=None):
        """Arm the train_mfu/train_mbu/train_tokens_per_sec gauges with
        a per-step cost (e.g. from :meth:`cost_analysis` or
        ``model.train_flops_per_token * tokens``).  The clock reads
        CUDA events it records at its window edges, never a device
        value."""
        from ..perf import TrainPerfClock
        if dtype is None:
            dtype = str(self.compute_dtype) if self.compute_dtype \
                is not None else "float32"
        if self._perf_clock is None:
            self._perf_clock = TrainPerfClock(
                flops_per_step, bytes_per_step, tokens_per_step,
                device=self.device, dtype=dtype)
        else:
            self._perf_clock.arm(flops_per_step, bytes_per_step,
                                 tokens_per_step, device=self.device)
        return self._perf_clock

    def cost_analysis(self, x, y):
        """The counted cost of one training step, ``{"flops",
        "bytes"}`` (``perf.counted_cost``: FlopCounterMode's products of
        the forward, backward and update, run on ``meta`` copies of the
        step's tensors, so nothing moves and the step's values stay as
        they are), or None where counting fails.  On success the MFU
        clock is armed with it (if not armed already), the role of the
        JAX step's XLA cost analysis."""
        from ..perf import jit_cost
        params, states, xm, ym = self._meta_args(x, y)
        twin = copy.copy(self)
        twin.params, twin.states = params, states
        twin.opt_state = self.opt.init(params)
        twin.remat = False
        twin._lr = torch.zeros((), device="meta")
        cost = jit_cost(lambda: twin._step(xm, ym, None))
        if cost is not None and self._perf_clock is None:
            self.arm_perf(cost["flops"], cost["bytes"])
        return cost

    def memory_analysis(self, x, y):
        """The planner's ``MemoryPlan`` of one step at the step's
        current knobs (the question the JAX step's ``memory_analysis``
        answers from XLA's buffer assignment; nothing runs).  The
        measured counterpart is ``perf.cuda_live_bytes`` over a step."""
        self._trace_liveness(x, y)
        return self._memory_plan(self.remat, self.grad_accum)

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
