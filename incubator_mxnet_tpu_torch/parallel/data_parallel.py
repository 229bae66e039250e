"""The training step (twin of
``incubator_mxnet_tpu/parallel/data_parallel.py``).

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

Over a mesh that spans a world of several ranks (``dist.init``, one
device a rank) the step is data and tensor parallel.  Each rank takes
its dp slice of the global batch.  A parameter whose rule shards it
over an axis of size > 1 (``tp``; ``dp`` for ZeRO's masters) is a
DTensor of this rank's slice on the mesh's ``DeviceMesh``, and the
forward runs under DTensor's ``implicit_replication`` (plain tensors
are replicated), so DTensor's sharding propagation inserts the tp
collectives of the forward and backward (Megatron's column/row split:
the partial sums of a row-parallel product are all-reduced on the way
out).  The batch is declared replicated over ``dp``: DTensor makes no dp
collective, and the step all-reduces the loss, every gradient (each
rank's local slice) and the floating states over ``dp`` in one flat
buffer, then divides by dp (a BatchNorm normalizes over its rank's
slice, and the moving stats are the ranks' mean).  ``zero=True`` with
dp > 1 shards the fp32 masters of the tp-replicated parameters, and
their optimizer state, over ``dp`` (first dim divisible by dp): the
forward all-gathers the cast masters (DTensor redistribution), and
each rank updates its slice.  On one CUDA rank the step is one captured
CUDA graph; over several, it is captured when the group's backend is
NCCL (its collectives can be captured) and runs op by op over gloo
(whose collectives cannot).  ``save_checkpoint`` / ``load_checkpoint``
write and restore reshardable generations (``parallel/checkpoint.py``):
a generation saved on one mesh restores onto another, or into the JAX
package's step.
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
from .mesh import current_mesh, is_dtensor, make_mesh
from .sharding import ShardingRules, tp_rules_for_dense_stacks

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

    mesh : a ``parallel.Mesh`` (default: the ambient ``use_mesh``
        mesh, else the world's ranks on 'dp', else the parameters'
        device)
    rules : ShardingRules for the parameters (default: replicated; on a
        tp mesh ``tp_rules_for_dense_stacks()``)
    batch_axis / seq_axis : the input dims split over 'dp' / 'sp' (an
        sp axis above 1 is ROADMAP item A9b)
    donate : kept for the JAX signature: the port always updates the
        parameters and optimizer state in place
    example_args : inputs for ``functionalize`` of a Gluon block
    zero : with dp > 1, shard the fp32 masters and optimizer state of
        the tp-replicated parameters over 'dp' (ZeRO-1)

    The parameters are the module's own fp32 ``nn.Parameter``s (the
    masters), updated in place; over a tp mesh (or with ``zero``) a
    sharded parameter's master is a DTensor the step holds
    (``write_back`` copies it into the module).
    ``trace_counts["train_step"]`` counts the CUDA graph captures (one
    per batch signature and generator).
    """

    def __init__(self, block, optimizer="sgd", optimizer_params=None,
                 mesh=None, loss_fn=None, rules=None, batch_axis=0,
                 seq_axis=None, donate=True, example_args=None,
                 compute_dtype=None, grad_accum=1, remat=False,
                 lr_schedule=None, zero=False):
        if isinstance(block, Block):
            block = functionalize(block, *(example_args or ()))
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
        self._lay_out(mesh, rules, batch_axis, seq_axis, zero)
        self._donate = donate
        self.opt_state = self.opt.init(self._local)
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

    def _lay_out(self, mesh, rules, batch_axis, seq_axis, zero):
        """The mesh, the rules and each parameter's master: the module's
        own tensor where its layout splits nothing, else a DTensor of
        this rank's slice (``NamedSharding.place``)."""
        if mesh is None:
            mesh = current_mesh()
        if mesh is None:
            from .mesh import _world
            mesh = make_mesh() if _world()[1] > 1 \
                else make_mesh(devices=[self.device])
        self.mesh = mesh
        if mesh.device != self.device:
            raise ValueError(f"the parameters are on {self.device}, the "
                             f"mesh's device is {mesh.device}")
        if seq_axis is not None and mesh.shape.get("sp", 1) > 1:
            raise NotImplementedError(
                "seq_axis over sp > 1: sequence parallelism is ROADMAP "
                "item A9b")
        if rules is None and (mesh.shape.get("tp", 1) > 1
                              or mesh.shape.get("ep", 1) > 1):
            rules = tp_rules_for_dense_stacks().restrict_to_axes(
                mesh.axis_names)
        self.rules = rules or ShardingRules()
        self.batch_axis = batch_axis
        self.seq_axis = seq_axis
        self.param_shardings = self.rules.shardings(mesh, self.params)
        self._compute_shardings = dict(self.param_shardings)
        self._dp = int(mesh.shape.get("dp", 1))
        self.zero = bool(zero) and self._dp > 1
        if self.zero:
            from .mesh import NamedSharding, PartitionSpec as P
            for n, p in self.params.items():
                if not self.param_shardings[n].is_replicated_everywhere():
                    continue        # rule-sharded (tp) leaves keep theirs
                for ax, d in enumerate(p.shape):
                    if d > 0 and d % self._dp == 0:
                        spec = [None] * p.ndim
                        spec[ax] = "dp"
                        self.param_shardings[n] = NamedSharding(
                            mesh, P(*spec))
                        break
        self._sharded = {n for n, sh in self.param_shardings.items()
                         if not sh.is_replicated_everywhere()}
        self._zero_names = [n for n in self.params
                            if self.param_shardings[n]
                            is not self._compute_shardings[n]]
        me = mesh.local_ids()[0]
        self._zero_index = {
            n: self.param_shardings[n].index_for(
                me, tuple(self.params[n].shape))
            for n in self._zero_names}
        if self._sharded:
            with torch.no_grad():
                for n in self._sharded:
                    self.params[n] = self.param_shardings[n].place(
                        self.params[n]).requires_grad_(True)
        # the tensors the update writes: each master's local slice
        self._local = {n: _local(p) for n, p in self.params.items()}

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

    def _forward(self, params, states, x, gens, training=True):
        """(outputs, new states) of the forward; its random masks come
        from ``gens[0]``.  With DTensor masters it runs under
        ``implicit_replication`` and hands back plain tensors (a
        sharded output is gathered, differentiably)."""
        sharded = bool(self._sharded)
        with self._replicating():
            if self.pure is not None:
                out, states = self.pure.apply(params, states, [x],
                                              gens[0], training=training)
            else:
                with _random.key_provider(gens[0]):
                    out = torch.func.functional_call(self.block, params,
                                                     (x,))
        if sharded:
            out = [_full(o) for o in out] \
                if isinstance(out, (list, tuple)) else _full(out)
            states = {n: _full(v) for n, v in states.items()}
        return out, states

    def _replicating(self):
        """DTensor's ``implicit_replication`` where there are DTensor
        masters (a plain tensor meeting one, in the forward or the
        backward, is replicated), else nothing."""
        if not self._sharded:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()

    def _leaves(self):
        """The tensors the gradient is taken of: the masters, and for
        ZeRO's dp-sharded masters their all-gathered fp32 copies (fresh
        leaves, so each rank's gradient is whole before the dp
        all-reduce; the update then takes this rank's slice)."""
        if not self.zero:
            return self.params
        out = dict(self.params)
        with torch.no_grad():
            for n in self._zero_names:
                v = self.params[n]
                out[n] = v.redistribute(
                    v.device_mesh, self._compute_shardings[n].placements())
        return {n: t.detach().requires_grad_(True) if n in self._zero_names
                else t for n, t in out.items()}

    def _grad_of(self, x, y, gen, states, leaves):
        """(loss, {name: fp32 gradient}, new states) of one
        (micro-)batch: the gradient of the tensors in ``leaves``
        (``_leaves()``), each as this rank's local tensor."""
        names = list(leaves)
        masters = list(leaves.values())
        params = leaves
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
        with self._replicating():
            grads = torch.autograd.grad(loss, masters, allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(_local(p)) if g is None
            else _local_grad(g, p)
            for n, p, g in zip(names, masters, grads)}, states

    def _step(self, x, y, gen):
        """The whole step on (x, y), in place: forward, backward, the
        ``grad_accum`` loop and the update; the states are written back
        into ``self.states``'s tensors.  Returns the loss."""
        accum = self.grad_accum
        leaves = self._leaves()
        if accum <= 1:
            loss, grads, states = self._grad_of(x, y, gen, self.states,
                                                leaves)
        else:
            grads, loss, states = None, None, self.states
            for xb, yb in zip(x.chunk(accum), y.chunk(accum)):
                lb, gb, states = self._grad_of(xb, yb, gen, states,
                                               leaves)
                if grads is None:
                    grads, loss = gb, lb
                else:
                    for n, g in gb.items():
                        grads[n].add_(g)
                    loss = loss + lb
            grads = {n: g / accum for n, g in grads.items()}
            loss = loss / accum
        if self._dp > 1:
            loss = self._reduce_dp(loss, grads, states)
        for n in self._zero_names:       # this rank's slice of the mean
            grads[n] = grads[n][self._zero_index[n]]
        self.opt.update(self._local, grads, self.opt_state, lr=self._lr)
        with torch.no_grad():
            for n, s in states.items():
                if s is not self.states[n]:
                    self.states[n].copy_(s)
        return loss

    @torch.no_grad()
    def _reduce_dp(self, loss, grads, states):
        """The mean over 'dp' of the loss, every gradient and the
        floating states, in place, as one flat all-reduce over this
        rank's dp group; returns the loss."""
        floats = [n for n, v in states.items() if v.is_floating_point()]
        parts = [loss.reshape(1).float()] \
            + [grads[n].reshape(-1).float() for n in grads] \
            + [states[n].reshape(-1).float() for n in floats]
        flat = torch.cat(parts)
        torch.distributed.all_reduce(flat, group=self.mesh.group("dp"))
        flat.div_(self._dp)
        out = list(flat.split([t.numel() for t in parts]))
        loss = out[0].reshape(()).to(loss.dtype)
        for i, n in enumerate(grads):
            grads[n].copy_(out[1 + i].view_as(grads[n]))
        for i, n in enumerate(floats):
            states[n].copy_(out[1 + len(grads) + i].view_as(states[n]))
        return loss

    def _mutable(self):
        """The tensors a step changes in place (a torch module's buffers
        too: a BatchNorm's running stats)."""
        buffers = list(self.block.buffers()) if self.pure is None else []
        return (list(self._local.values())
                + _graph.tensors_of(self.opt_state)
                + list(self.states.values()) + buffers)

    def _dp_slice(self, a):
        """This rank's dp slice of a global batch (along
        ``batch_axis``)."""
        if self._dp <= 1:
            return a
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        n = a.shape[self.batch_axis]
        if n % self._dp:
            raise ValueError(f"global batch {n} is not divisible by "
                             f"dp={self._dp}")
        c = self.mesh.coord(self.mesh.local_ids()[0])["dp"]
        return a.narrow(self.batch_axis, c * (n // self._dp), n // self._dp)

    def _prepare(self, x, y, generator):
        """(x, y, generator, the generators the step draws from) for one
        step; writes this step's learning rate and syncs remat's twin."""
        x, y = self._batch(self._dp_slice(x)), self._batch(self._dp_slice(y))
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
        once more.  Over several ranks, each passes the same global
        batch and runs on its dp slice; the returned loss is the global
        batch's mean."""
        from ..dist import elastic_probe, group_backend
        from ..resilience import as_oom_error, check_oom
        elastic_probe()     # elastic:rank<N> injection
        capture = self.device.type == "cuda" and (
            not self.mesh.spans_world or group_backend() == "nccl")
        for attempt in (0, 1):
            try:
                if not self._planned:
                    self._preflight(x, y)
                # mem:oom injection point; one env read without a spec
                check_oom("sharded_train_step")
                if not capture:
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
            params_bytes=mp.sharded_tree_bytes(self.params)
            + mp.tree_bytes(self.states),
            max_param_bytes=mp.sharded_tree_bytes(self.params),
            optimizer_bytes=mp.tree_bytes(self.opt_state),
            grad_accum=grad_accum, remat=remat, donate=True,
            batch_shards=self._dp)

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
        # one rank's work, on plain meta copies: no collective, no slice
        twin._local, twin._dp, twin.zero = params, 1, False
        twin._sharded, twin._zero_names = set(), []
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
            return self._forward(self.params, self.states,
                                 self._batch(x), [None],
                                 training=False)[0]
        if self._sharded:
            self.write_back()
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
        this copies a Gluon block's states (BatchNorm's moving stats)
        and the whole of each DTensor master (gathered)."""
        full = {n: _full(p.detach()) for n, p in self.params.items()}
        if self.pure is not None:
            self.pure.write_back(full, self.states)
            return
        with torch.no_grad():
            live = dict(self.block.named_parameters())
            for n in self._sharded:
                live[n].copy_(full[n])

    # ------------------------------------------------------- checkpoint
    def save_checkpoint(self, path, data_state=None):
        """Write params, states and optimizer state to ``path`` (a
        checkpoint directory) as one sharded generation
        (``parallel/checkpoint.py``): each rank writes the slices it
        owns, the lowest rank the manifest, and generations accumulate
        with corrupt-shard fallback on load.  ``data_state`` (an input
        iterator's ``state_dict()``) rides in the same generation.  The
        tree is the JAX step's: ``params``, ``states``, ``opt_state``
        (Adam's ``t`` as int32) and ``step_count``.  Returns the
        generation directory."""
        from . import checkpoint as _ckpt
        tree = self._ckpt_tree()
        return _ckpt.save_sharded(
            path, tree, self.mesh, step=int(self.step_count),
            data_state=data_state,
            extra={"optimizer": foptim.state_structure(tree["opt_state"])})

    def load_checkpoint(self, path):
        """Restore the newest valid generation under ``path`` into this
        step, in place, in this step's layout: each leaf is assembled
        from the saved slices that overlap this rank's own, so the save
        may have run on another mesh or world size (or in the JAX
        package).  Returns the generation's data-iterator companion
        state (or None)."""
        from . import checkpoint as _ckpt
        restored, manifest, gen_dir = _ckpt.load_latest(
            path, self._ckpt_tree(), self.mesh)
        self._restore(restored)
        return _ckpt.load_data_companion(gen_dir, manifest)

    def _restore(self, restored):
        """Write a tree in ``_ckpt_tree``'s layout into the step's
        tensors, in place (a captured graph keeps reading them)."""
        with torch.no_grad():
            for n, v in restored["params"].items():
                self._local[n].copy_(_local(v))
            for n, v in restored["states"].items():
                self.states[n].copy_(v)
            foptim.load_state(self.opt_state, restored["opt_state"])
        self.step_count = int(restored["step_count"])

    def _ckpt_tree(self):
        """Copies of the step's state in the JAX step's tree, each
        optimizer-state leaf laid out as its parameter's master."""
        def like(tree):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = like(v)
                elif k in self._sharded and _local(v) is v:
                    m = self.params[k]
                    out[k] = _dtensor_like(v, m)
                else:
                    out[k] = v
            return out
        return {"params": {n: p.detach().clone()
                           for n, p in self.params.items()},
                "states": {n: v.detach().clone()
                           for n, v in self.states.items()},
                "opt_state": like(foptim.checkpoint_state(self.opt_state)),
                "step_count": torch.tensor(self.step_count,
                                           dtype=torch.int32)}


def _local(t):
    """A DTensor's local slice (sharing its storage); any other tensor
    itself."""
    local = getattr(t, "_local_tensor", None)
    return t if local is None else local


def _local_grad(g, p):
    """The gradient ``g`` of master ``p`` as ``p``'s local slice
    (redistributed first when DTensor gave it another placement)."""
    if not is_dtensor(g):
        return g
    if not is_dtensor(p):               # a replicated master
        return g.full_tensor()
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g.to_local()


def _full(t):
    """A DTensor gathered into a plain tensor (differentiably); any
    other value as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _dtensor_like(local, master):
    """``local`` (a slice shaped like ``master``'s) as a DTensor with
    ``master``'s placements."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, master.device_mesh, master.placements,
                              run_check=False, shape=master.shape,
                              stride=master.stride())
