"""Multi-process bootstrap and cross-process collectives (twin of
``incubator_mxnet_tpu/dist.py``), on ``torch.distributed``.

There are no parameter servers, as in the JAX package: processes join
one ``torch.distributed`` process group (rank 0's TCP store in the
place of the JAX coordinator) and gradient exchange is a collective
over every process.  The launcher (``tools/launch.py``) sets the env
contract:

    MXTPU_NUM_WORKERS   number of worker processes
    MXTPU_WORKER_RANK   this process's rank
    MXTPU_COORD_ADDR    host:port of rank 0's store (the coordinator)
    MXTPU_RANK_FROM_MPI 1: the rank comes from the MPI runtime's env

The backend is a rule, not a fallback (:func:`backend`): NCCL when
every rank has a card of its own (CUDA is there, ``MXTPU_FORCE_CPU`` is
not set, and the workers on this host are no more than its cards), gloo
otherwise: on the CPU, and for several ranks on fewer cards (two ranks
on one H100: NCCL refuses two ranks on one device).  A collective the
chosen backend refuses (NCCL takes no CPU tensor) raises.  Gloo takes
this module's collectives for CUDA tensors (through the host), but not
every functional one DTensor calls: ``tools/gloo_cuda_probe.py`` lists
what a host's torch takes.

``init()`` is idempotent, and a no-op for one process without an
explicit coordinator, so the same script runs launched directly or
under the launcher.  With ``coordinator_address`` given, a world of one
joins too (a one-rank group), and its collectives then run through the
backend.
"""
import datetime
import os

import torch

__all__ = ["init", "is_initialized", "shutdown", "rank",
           "num_workers", "world_generation", "elastic_probe",
           "allreduce_sum", "allreduce_max", "broadcast", "barrier",
           "backend", "rank_device", "group_backend"]

_initialized = False


def env_num_workers():
    return int(os.environ.get("MXTPU_NUM_WORKERS", "1"))


def is_initialized():
    return _initialized


def _env_rank():
    """Worker rank from the launch environment: MXTPU_WORKER_RANK, or
    under ``--launcher mpi`` (MXTPU_RANK_FROM_MPI=1) the MPI runtime's
    own variable (OpenMPI/PMIx/MPICH/Slurm)."""
    if os.environ.get("MXTPU_RANK_FROM_MPI") == "1":
        for var in ("OMPI_COMM_WORLD_RANK", "PMIX_RANK", "PMI_RANK",
                    "SLURM_PROCID"):
            if var in os.environ:
                return int(os.environ[var])
        raise RuntimeError(
            "MXTPU_RANK_FROM_MPI=1 but no MPI rank variable found "
            "(OMPI_COMM_WORLD_RANK/PMIX_RANK/PMI_RANK/SLURM_PROCID) "
            "— was this process actually started by mpirun?")
    return int(os.environ.get("MXTPU_WORKER_RANK", "0"))


def _force_cpu():
    return os.environ.get("MXTPU_FORCE_CPU", "") not in ("", "0")


def backend(num_workers_=None):
    """The backend a world of ``num_workers_`` ranks (default: the
    launch env's) joins with: 'nccl' when every rank has a card of its
    own, else 'gloo'.  The workers of one launch share a host (the
    launcher's local mode), so 'a card of its own' means no more
    workers than this host's cards."""
    n = num_workers_ if num_workers_ is not None else env_num_workers()
    if _force_cpu() or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if max(1, n) <= torch.cuda.device_count() else "gloo"


def group_backend():
    """The joined group's backend, or None before :func:`init`."""
    if not torch.distributed.is_initialized():
        return None
    return torch.distributed.get_backend()


def rank_device(rank_=None):
    """The device this rank computes on: card ``rank % cards`` where
    there are cards (two gloo ranks on one card share it), else the
    host."""
    if _force_cpu() or not torch.cuda.is_available():
        return torch.device("cpu")
    r = rank() if rank_ is None else rank_
    return torch.device("cuda", r % torch.cuda.device_count())


def init(coordinator_address=None, num_workers_=None, rank_=None):
    """Join the process group (idempotent); returns this rank.

    Arguments default to the launcher's env contract.  The join is
    retried with exponential backoff (``resilience.RetryPolicy``'s env
    knobs): rank 0 may still be binding its port when late workers
    first connect.  Every join and every collective of the group waits
    at most MXTPU_COLLECTIVE_TIMEOUT seconds (the group's timeout).
    The launcher's heartbeat (MXTPU_HEARTBEAT_FILE), the telemetry
    emitter, the diverged-exit hook and the debugz endpoint start here,
    before the join, so a rank wedged in the join still answers."""
    global _initialized
    from . import debugz, resilience, telemetry
    resilience.start_heartbeat()
    telemetry.maybe_start_emitter()
    resilience.install_diverged_exithook()
    debugz.maybe_start("train")
    if _initialized:
        return rank()
    n = num_workers_ if num_workers_ is not None else env_num_workers()
    if n <= 1 and coordinator_address is None:
        return 0
    r = rank_ if rank_ is not None else _env_rank()
    coord = coordinator_address or os.environ.get("MXTPU_COORD_ADDR")
    if coord is None:
        raise RuntimeError(
            "MXTPU_NUM_WORKERS>1 but no MXTPU_COORD_ADDR; launch "
            "through tools/launch.py or pass coordinator_address")
    name = backend(n)
    timeout = resilience.collective_timeout()
    timeout = datetime.timedelta(
        seconds=timeout if timeout > 0 else 1800.0)
    if name == "nccl":
        torch.cuda.set_device(rank_device(r))

    def join():
        resilience.inject("dist", "init")
        try:
            resilience.call_transient_mapped(
                torch.distributed.init_process_group, name,
                init_method=f"tcp://{coord}", world_size=n, rank=r,
                timeout=timeout,
                markers=resilience.JOIN_TRANSIENT_MARKERS)
        except resilience.ResilienceError:
            shutdown()
            raise

    resilience.retry_call(
        join, op_name=f"dist.init(rank={r}, coord={coord})",
        retry_on=(resilience.TransientError,))
    _initialized = True
    _note_world(r, n)
    return r


def _note_world(r, n):
    """Attribute this boot's world in telemetry and tracing: under the
    launcher's elastic mode every (re)launch carries a rising
    MXTPU_WORLD_GENERATION."""
    from . import telemetry, tracing
    from .utils.env import get_env
    gen = get_env("MXTPU_WORLD_GENERATION")
    if gen <= 0:
        return
    telemetry.gauge("elastic_world_generation").set(gen)
    if gen > 1:
        telemetry.counter("elastic_restarts_total").inc()
        tracing.trace_event("elastic_world_resize", generation=gen,
                            world=n, rank=r,
                            elastic=bool(get_env("MXTPU_ELASTIC")))


def shutdown():
    """Leave the process group, so that a different world can join in
    this process (elastic recovery: shrink or grow).  Safe to call when
    never joined and safe to call twice; after it :func:`init` works
    again with fresh env or arguments."""
    global _initialized
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        try:
            torch.distributed.destroy_process_group()
        except Exception:   # a broken world: its state is gone anyway
            pass
    _initialized = False


def world_generation():
    """The launcher-exported world generation (0 when this process is
    not launcher-managed)."""
    from .utils.env import get_env
    return get_env("MXTPU_WORLD_GENERATION")


def elastic_probe():
    """Per-step elastic fault hook: scope ``elastic``, op ``rank<N>``
    (``elastic:rank1:3:kill`` hard-kills rank 1 on its 3rd step).  One
    env read when no fault spec is set."""
    from . import resilience
    if not resilience.faults_active():
        return
    r = rank() if _initialized else \
        int(os.environ.get("MXTPU_WORKER_RANK", "0"))
    resilience.inject("elastic", "rank%d" % r)


def rank():
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def num_workers():
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def _joined():
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def _guarded(op, tag, body):
    """Run a collective body under the resilience contract: the
    ``collective:<op>`` fault probe runs inside the deadline-wrapped
    callable (an injected ``hang`` is cut by MXTPU_COLLECTIVE_TIMEOUT
    like a wedged peer); an in-op failure on a multi-rank world is a
    ``CollectiveAbortedError``, never retried in place (peers may have
    completed the op).  Without faults and with no deadline or one
    process, the body is called straight through."""
    from . import resilience

    multi = num_workers() > 1

    def entered_body():
        if not multi:
            return body()
        try:
            return body()
        except resilience.ResilienceError:
            raise
        except (RuntimeError, OSError, ConnectionError) as exc:
            from . import telemetry
            telemetry.counter("collective_aborts_total").inc()
            raise resilience.CollectiveAbortedError(
                f"collective {op} (tag={tag} rank={rank()}) failed "
                f"in-op: {exc}; not retried — peers may have completed "
                "it, and re-entering would desynchronize the ranks") \
                from exc

    def checked():
        resilience.inject("collective", op)
        return entered_body()

    timeout = resilience.collective_timeout()
    if not resilience.faults_active() and (timeout <= 0 or not multi):
        return entered_body()
    try:
        return resilience.deadline_call(
            checked, timeout, op_name=f"collective {op}",
            detail=f"tag={tag} rank={rank()} "
                   f"num_workers={num_workers()}")
    except resilience.DeadlineExceededError as exc:
        # a peer is dead or wedged (this rank is healthy): only such
        # deadline errors may take the elastic exit
        exc.collective = True
        raise


def _as_tensor(v):
    """A tensor to reduce: tensors as they are (NDArrays by their
    data), numbers and numpy arrays on this rank's device."""
    from .ndarray.ndarray import NDArray
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    import numpy as np
    return torch.as_tensor(np.asarray(v), device=rank_device())


def _tree_map(fn, value):
    if isinstance(value, dict):
        return {k: _tree_map(fn, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_tree_map(fn, v) for v in value)
    return fn(_as_tensor(value))


def _reduce(value, op):
    def one(t):
        out = t.detach().clone()
        torch.distributed.all_reduce(out, op=op)
        return out
    return _tree_map(one, value)


def allreduce_sum(value):
    """Sum ``value`` (a tensor, NDArray, number or numpy array, or a
    dict/list of them) over every process; returns new tensors on the
    inputs' devices.  Under MXTPU_COLLECTIVE_TIMEOUT (``_guarded``)."""
    def body():
        if not _joined():
            return value
        return _reduce(value, torch.distributed.ReduceOp.SUM)
    return _guarded("allreduce", "-", body)


def allreduce_max(value):
    """Elementwise maximum of ``value`` over every process: the step
    sentinel's rank-consistent verdict (every rank's bad-step window
    count in, the same maximum out, so no rank skips alone)."""
    def body():
        if not _joined():
            return value
        return _reduce(value, torch.distributed.ReduceOp.MAX)
    return _guarded("allreduce", "max", body)


def broadcast(value, root=0):
    """Every process receives ``root``'s value (tensor or dict/list of
    them; each rank passes a value of the same shape)."""
    def body():
        if not _joined():
            return value

        def one(t):
            out = t.detach().clone()
            torch.distributed.broadcast(out, src=root)
            return out
        return _tree_map(one, value)
    return _guarded("broadcast", f"root={root}", body)


def barrier(tag="mxtpu_barrier"):
    """Wait until every process has reached this barrier."""
    def body():
        if not _joined():
            return
        if group_backend() == "nccl":
            torch.distributed.barrier(
                device_ids=[torch.cuda.current_device()])
        else:
            torch.distributed.barrier()
    _guarded("barrier", tag, body)
