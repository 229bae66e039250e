"""The port's serving fleet (``incubator_mxnet_tpu_torch/serving/{rpc,
replica,router}.py``) on the CPU, at the JAX fleet tests' tiny width
(vocab 37, d_model 32, 2 layers, 4 heads, max_len 64).

Twins of ``tests/test_serving_fleet.py``: replicas on daemon threads
behind a ``ServingRouter`` finish token-identical to ``generate()`` with
no leaked block; typed admission shedding, drain rejection and the
deadline net; prefix affinity; the breaker's exactly-one half-open
probe; the replica list and port from the environment.  Across
packages (the frames are byte-equal): a port router over a port replica
and a JAX replica holding the same weights, and a JAX router over a
port replica, both give the JAX ``generate()``'s tokens.  One test runs
two replica processes on the host (``MXTPU_FORCE_CPU=1``), one killed
by an injected ``router:replica`` fault: exactly one terminal per
request, the unkilled tokens, no leak on the survivor, and its drain
snapshot restores in the port's engine.  Last, the fleet files pass
``ci/lint.py``'s fleet rules (socket waits, monotonic clocks, hot-path
syncs), which are keyed on the JAX package's paths.

Every wait has a deadline; every subprocess is killed in a ``finally``.
"""
import importlib.util
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import serving as jserving  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo import transformer as jtr  # noqa: E402
from incubator_mxnet_tpu.serving import replica as jreplica  # noqa: E402
from incubator_mxnet_tpu.serving import router as jrouter  # noqa: E402
from incubator_mxnet_tpu_torch import resilience as rz  # noqa: E402
from incubator_mxnet_tpu_torch import serving  # noqa: E402
from incubator_mxnet_tpu_torch import tracing  # noqa: E402
from incubator_mxnet_tpu_torch.convert import load_reference_weights  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import (  # noqa: E402
    TransformerLM)
from incubator_mxnet_tpu_torch.serving import (  # noqa: E402
    EXPIRED, FINISHED, ServeRejectedError, ServingEngine, ServingRouter)
from incubator_mxnet_tpu_torch.serving import replica as replica_mod  # noqa: E402
from incubator_mxnet_tpu_torch.serving import router as router_mod  # noqa: E402
from incubator_mxnet_tpu_torch.serving import rpc  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 37
CFG = dict(d_model=32, n_layers=2, n_heads=4, max_len=64)
ENGINE = dict(max_batch=2, block_size=4, num_blocks=64,
              prefix_cache=False)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("MXTPU_FAULT_SPEC", raising=False)
    rz.reset_faults()
    yield
    rz.reset_faults()


_NETS = {}


def _net():
    """The replica CLI's model (``_build_tiny("")``), on the host."""
    if "port" not in _NETS:
        _NETS["port"] = replica_mod._build_tiny("", device="cpu")
    return _NETS["port"]


def _jax_pair():
    """(JAX tiny LM, the port's LM with its weights), built once."""
    if "jax" not in _NETS:
        mx.random.seed(0)
        net = jtr.TransformerLM(VOCAB, **CFG)
        net.initialize(mx.initializer.Xavier())
        net(mx.nd.array(np.zeros((1, 2), np.int32)))   # settles shapes
        wts = jax.tree_util.tree_map(np.asarray, net._decode_weights())
        port = TransformerLM(VOCAB, **CFG, device="cpu")
        _NETS["jax"] = (net, load_reference_weights(port, wts))
    return _NETS["jax"]


def _gen_ref(net, prompts, max_new):
    """generate() over equal-length prompts, one batch."""
    out = net.generate(torch.tensor(prompts), max_new)
    return [[int(t) for t in row] for row in out]


def _start(net, name, package=replica_mod, **kw):
    """One in-process replica on an ephemeral port, its engine loop on a
    daemon thread."""
    srv = package.ReplicaServer(net, name=name, port=0,
                                **dict(ENGINE, **kw))
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name=f"replica-loop-{name}")
    t.start()
    return srv, t


def _stop(reps):
    for srv, t in reps:
        srv.close()
        t.join(timeout=10)


def _prompts(seed, n, length):
    rs = np.random.RandomState(seed)
    return [list(rs.randint(0, VOCAB, length)) for _ in range(n)]


# ------------------------------------------------------------ surface
def test_exports_match_jax():
    assert serving.__all__ == jserving.__all__
    from incubator_mxnet_tpu.serving import rpc as jrpc
    assert rpc.__all__ == jrpc.__all__
    for name in rpc._PRIVATE_REEXPORTS:
        assert getattr(rpc, name) is getattr(serving.rpc, name)
    assert rpc.MAGIC == jrpc.MAGIC and rpc._HEADER.format == \
        jrpc._HEADER.format
    assert rpc.DEFAULT_FAULT_SCOPE == ("router", "net")


def test_client_refuses_a_self_connect(monkeypatch):
    """A retrying client can be handed its own socket by the kernel when
    it dials a local ephemeral port nothing listens on (a dead
    replica's): the link would read its own frames.  connect() refuses
    it as a failed attempt."""
    def self_connected(addr, timeout=None):
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        sock.connect(sock.getsockname())
        return sock

    monkeypatch.setattr(socket, "create_connection", self_connected)
    cli = rpc.RpcClient("127.0.0.1", 9)
    with pytest.raises(rpc.RpcError, match="itself"):
        cli.connect()
    assert not cli.connected


# --------------------------------------------------- in-process fleet
def test_fleet_token_identical_no_leaks_then_drains():
    net = _net()
    prompts = _prompts(60, 6, 7)
    refs = _gen_ref(net, prompts, 6)
    reps = [_start(net, f"f{i}") for i in range(2)]
    tracing.get_recorder().clear()
    router = ServingRouter(
        replicas=[("127.0.0.1", r.port) for r, _ in reps],
        poll_interval=0.01).connect()
    try:
        reqs = [router.submit(p, 6, deadline=300.0) for p in prompts]
        assert router.wait(reqs, timeout=120.0)
        for req, ref in zip(reqs, refs):
            assert req.state == FINISHED and req.tokens == ref
            assert len(tracing.events("router_terminal", rid=req.id)) == 1
        assert {r.link for r in reqs} == {"replica0", "replica1"}
        for name in ("replica0", "replica1"):
            st = router.replica_stats(name)
            assert st["num_allocated"] == 0 and st["pool_live"] == {}
            assert st["memory"]["host_rss_bytes"] > 0
        assert router.drain(wait=True, timeout=60.0) == \
            {"replica0", "replica1"}
        with pytest.raises(ServeRejectedError, match="draining"):
            router.submit([1, 2, 3], 2)
    finally:
        router.close()
        _stop(reps)


def test_admission_sheds_typed_and_deadline_net():
    router = ServingRouter(replicas=[], queue_limit=2, queue_tokens=50,
                           poll_interval=0.01, expiry_grace=0.05)
    try:
        # the router's handles, not the registry: a test that resets the
        # registry leaves the module's counters out of it
        rej0 = router_mod._m_rejected.value
        req = router.submit([1, 2, 3], 4, deadline=0.1)
        with pytest.raises(ServeRejectedError, match="queue_tokens"):
            router.submit(list(range(48)), 2)
        router.submit([4, 5], 2, deadline=0.1)
        with pytest.raises(ServeRejectedError, match="queue_limit"):
            router.submit([6], 2)
        assert router_mod._m_rejected.value - rej0 == 2
        # no replica can ever serve these: the deadline net ends each in
        # exactly one terminal
        assert router.wait(timeout=30.0)
        assert req.state == EXPIRED and "router net" in req.error
        assert req.id in router._terminal_ids and not router._pending
        router.drain(wait=False)
        with pytest.raises(ServeRejectedError, match="draining"):
            router.submit([7], 2)
    finally:
        router.close()


def test_prefix_affinity_and_breaker_single_probe():
    router = ServingRouter(replicas=["127.0.0.1:9", "127.0.0.1:10"],
                           block_size=4)
    try:
        now = time.monotonic()
        for link in router._links.values():
            link.alive = True
            link.last_heard = now
        req = router_mod.FleetRequest(0, list(range(12)), 4)
        assert router._pick(req).name == "replica0"     # least queued
        router._remember_affinity(req, router._links["replica1"])
        assert router._pick(req).name == "replica1"     # cache affinity
        router._links["replica1"].inflight = {1, 2, 3}
        assert router._pick(req).name == "replica1"     # beats load
        router._links["replica1"].alive = False
        assert router._pick(req).name == "replica0"     # falls back
        # the chain keys are the prefix cache's, on the port's seed
        assert router._chain_keys(list(range(12))) == jrouter.ServingRouter(
            replicas=[], block_size=4)._chain_keys(list(range(12)))
    finally:
        router.close()
    b = router_mod._Breaker(threshold=2, cooldown=5.0)
    t0 = 100.0
    assert b.allow(t0) and b.fail(t0) is False and b.state == "closed"
    assert b.fail(t0) is True and b.state == "open"
    assert not b.allow(t0 + 4.9)
    assert b.allow(t0 + 5.0) and b.state == "half_open"
    b.probe_rid = 42                    # the dispatch path stamps it
    assert not b.allow(t0 + 5.1)        # EXACTLY one probe in flight
    assert b.fail(t0 + 5.3) is True     # probe failed: re-open
    assert b.state == "open" and b.probe_rid is None
    assert not b.allow(t0 + 5.4) and b.allow(t0 + 10.4)
    b.probe_rid = 43
    b.ok()
    assert b.state == "closed" and b.allow(t0 + 10.5)


def test_replica_port_and_router_list_from_environment(monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MXTPU_REPLICA_PORT", str(port))
    srv = replica_mod.ReplicaServer(_net(), name="env", **ENGINE)
    try:
        assert srv.port == port
    finally:
        srv.close()
    monkeypatch.setenv("MXTPU_REPLICA_ADDRS",
                       "127.0.0.1:7001,127.0.0.1:7002")
    router = ServingRouter()
    try:
        assert [(l.client.host, l.client.port)
                for l in router._links.values()] == \
            [("127.0.0.1", 7001), ("127.0.0.1", 7002)]
    finally:
        router.close()


# ---------------------------------------------------- across packages
def test_cross_package_fleets_match_jax_generate():
    """A port router over a port replica and a JAX replica that hold the
    same weights, then a JAX router over a port replica: every token is
    the JAX generate()'s."""
    net, port = _jax_pair()
    prompts = _prompts(64, 4, 6)
    refs = [[int(t) for t in row] for row in net.generate(
        mx.nd.array(np.asarray(prompts, np.int32)), 7).asnumpy()]
    reps = [_start(port, "p0"), _start(net, "j0", package=jreplica)]
    router = ServingRouter(
        replicas=[("127.0.0.1", r.port) for r, _ in reps],
        poll_interval=0.01).connect()
    try:
        reqs = [router.submit(p, 7, deadline=300.0) for p in prompts]
        assert router.wait(reqs, timeout=120.0)
        assert [r.tokens for r in reqs] == refs
        assert {r.link for r in reqs} == {"replica0", "replica1"}
        assert router.replica_stats("replica1")["num_allocated"] == 0
    finally:
        router.close()
        _stop(reps)
    reps = [_start(port, "p1")]
    router = jrouter.ServingRouter(
        replicas=[("127.0.0.1", reps[0][0].port)],
        poll_interval=0.01).connect()
    try:
        reqs = [router.submit(p, 7, deadline=300.0) for p in prompts]
        assert router.wait(reqs, timeout=120.0)
        assert [r.tokens for r in reqs] == refs
        assert router.replica_stats("replica0")["pool_live"] == {}
    finally:
        router.close()
        _stop(reps)


# ------------------------------------------------ replica processes
def _spawn(tmp_path, idx, fault_spec=""):
    port_file = tmp_path / f"port{idx}"
    log = open(tmp_path / f"replica{idx}.log", "wb")
    env = dict(os.environ, MXTPU_FORCE_CPU="1", OMP_NUM_THREADS="1")
    env.pop("MXTPU_FAULT_SPEC", None)
    if fault_spec:
        env["MXTPU_FAULT_SPEC"] = fault_spec
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.serving.replica",
         "--port-file", str(port_file), "--name", f"proc{idx}",
         "--max-batch", "2", "--block-size", "4", "--num-blocks", "64",
         "--prefix-cache", "0"],
        cwd=REPO, env=env, stdout=log, stderr=log)
    return proc, port_file, log


def _wait_ports(port_files, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(f.exists() for f in port_files):
            return [int(f.read_text()) for f in port_files]
        time.sleep(0.05)
    raise AssertionError("replica processes never came up")


def test_replica_processes_kill_failover_and_drain(tmp_path):
    """Two replica processes on the host; the first dies (os._exit(1))
    at its 2nd dispatch.  Its work re-homes: exactly one terminal per
    request with the unkilled tokens, no leaked block on the survivor.
    Then a drain mid-stream: the survivor exits 0 and its snapshot
    restores in the port's engine with the same tokens."""
    net = _net()
    prompts = _prompts(77, 4, 8)
    refs = _gen_ref(net, prompts, 8)
    procs = [_spawn(tmp_path, 0, "router:replica:2:kill"),
             _spawn(tmp_path, 1)]
    router = None
    try:
        ports = _wait_ports([pf for _, pf, _ in procs])
        tracing.get_recorder().clear()
        red0 = router_mod._m_redispatch.value
        router = ServingRouter(
            replicas=[("127.0.0.1", p) for p in ports],
            poll_interval=0.02, stale_after=5.0).connect()
        reqs = [router.submit(p, 8, deadline=300.0) for p in prompts]
        assert router.wait(reqs, timeout=120.0)
        for req, ref in zip(reqs, refs):
            assert req.state == FINISHED, (req.id, req.error)
            assert req.tokens == ref
            assert len(tracing.events("router_terminal", rid=req.id)) == 1
        assert procs[0][0].wait(timeout=60) == 1
        assert sum(r.redispatches for r in reqs) >= 1
        assert router_mod._m_redispatch.value > red0
        st = router.replica_stats("replica1")
        assert st["num_allocated"] == 0 and st["pool_live"] == {}
        # eight requests on one survivor's two slots: four waves, so the
        # drain below, sent at the first token, finds work queued
        prompts2 = _prompts(78, 8, 6)
        refs2 = _gen_ref(net, prompts2, 12)
        reqs2 = [router.submit(p, 12, deadline=300.0) for p in prompts2]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and \
                not any(r.generated for r in reqs2):
            router.poll()
            time.sleep(0.002)
        snapdir = tmp_path / "snaps"
        snapdir.mkdir()
        assert router.drain(wait=True, timeout=60.0,
                            snapshot_dir=str(snapdir)) == {"replica1"}
        assert procs[1][0].wait(timeout=60) == 0
        eng = ServingEngine.restore(net, str(snapdir / "replica1.snap"),
                                    **ENGINE)
        restored = eng.run()
        assert eng.pool.num_allocated == 0
        for req, ref in zip(reqs2, refs2):
            if req.done:
                assert req.state == FINISHED and req.tokens == ref
            else:
                assert req.id in restored       # never silently lost
            if req.id in restored:
                assert restored[req.id] == ref
        assert any(not r.done for r in reqs2)
    finally:
        if router is not None:
            router.close()
        for proc, _, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            log.close()


# ------------------------------------------------------------- lint
def test_fleet_files_pass_the_fleet_lint_rules(tmp_path):
    """ci/lint.py keys its fleet rules (bounded socket waits, monotonic
    deadline clocks, one host sync per serving iteration) on the JAX
    package's paths: the port's files, copied there, pass them."""
    spec = importlib.util.spec_from_file_location(
        "lint", os.path.join(REPO, "ci", "lint.py"))
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    pkg = os.path.join(REPO, "incubator_mxnet_tpu_torch")
    dst = tmp_path / "incubator_mxnet_tpu"
    (dst / "serving").mkdir(parents=True)
    shutil.copy(os.path.join(pkg, "rpc.py"), dst / "rpc.py")
    files = [dst / "rpc.py"]
    for name in sorted(os.listdir(os.path.join(pkg, "serving"))):
        if name.endswith(".py"):
            shutil.copy(os.path.join(pkg, "serving", name),
                        dst / "serving" / name)
            files.append(dst / "serving" / name)
    assert len(files) == 10
    assert [p for f in files for p in lint.check_file(f)] == []
    # the rules do fire on these paths
    bad = dst / "serving" / "router.py"
    bad.write_text("import socket\nimport time\ns = socket.socket()\n"
                   "c = s.accept()\nt = time.time()\n")
    assert len(lint.check_file(bad)) == 2
