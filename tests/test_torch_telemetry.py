"""The port's operability base against the JAX package's: the flag
registry, the metric registry and its exposition, the fault grammar and
injection, retry schedules, the RPC frame bytes (and a client of each
package talking to a server of the other), the flight recorder and the
compile ledger, debugz, heartbeats, fork safety, and the spans and
counters of a ``Module.fit`` on the CPU."""
import json
import os
import signal
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import debugz as jdebugz  # noqa: E402
from incubator_mxnet_tpu import resilience as jres  # noqa: E402
from incubator_mxnet_tpu import rpc as jrpc  # noqa: E402
from incubator_mxnet_tpu import telemetry as jtel  # noqa: E402
from incubator_mxnet_tpu import tracing as jtr  # noqa: E402
from incubator_mxnet_tpu.utils import env as jenv  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch import debugz as pdebugz  # noqa: E402
from incubator_mxnet_tpu_torch import resilience as pres  # noqa: E402
from incubator_mxnet_tpu_torch import rpc as prpc  # noqa: E402
from incubator_mxnet_tpu_torch import telemetry as ptel  # noqa: E402
from incubator_mxnet_tpu_torch import tracing as ptr  # noqa: E402
from incubator_mxnet_tpu_torch.utils import env as penv  # noqa: E402
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

TEL = {"jax": jtel, "port": ptel}
RES = {"jax": jres, "port": pres}
TR = {"jax": jtr, "port": ptr}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("MXTPU_TELEMETRY", "MXTPU_TELEMETRY_FILE",
                 "MXTPU_FAULT_SPEC", "MXTPU_TRACE_DUMP",
                 "MXTPU_WORKER_RANK", "MXTPU_HEARTBEAT_FILE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MXTPU_RPC_TIMEOUT", "10")
    # modules hold the counters they resolved at import (rpc, the
    # router): the metrics are put back after the test, so that later
    # test files in this process still read those counters
    held = {k: dict(t.get_registry()._metrics) for k, t in TEL.items()}

    def clean():
        for t in TEL.values():
            t.stop_emitter()
            t.get_registry().reset()
            t.reset_anomaly_for_tests()
        for r in RES.values():
            r.reset_faults()
            r.stop_heartbeat()
        for t in TR.values():
            t.reset_for_tests()
    clean()
    yield
    clean()
    for k, t in TEL.items():
        t.get_registry()._metrics.update(held[k])
    pdebugz.stop()
    jdebugz.stop()


# ------------------------------------------------------------ env registry
def test_list_env_matches_jax():
    ref, port = jenv.list_env(), penv.list_env()
    assert sorted(ref) == sorted(port) and len(port) == 85
    for name, flag in ref.items():
        mine = port[name]
        assert (mine.type, mine.default, mine.help) == \
            (flag.type, flag.default, flag.help), name
    assert mt.list_env().keys() == ref.keys()


FLAG_CASES = [
    ("MXTPU_DATA_TIMEOUT", None), ("MXTPU_DATA_TIMEOUT", "2.5"),
    ("MXTPU_DATA_TIMEOUT", "soon"), ("MXTPU_GRAPH_OPT", "2"),
    ("MXTPU_GRAPH_OPT", "two"), ("MXTPU_SERVE_PREFIX_CACHE", "0"),
    ("MXTPU_SERVE_PREFIX_CACHE", "False"),
    ("MXTPU_SERVE_PREFIX_CACHE", "maybe"), ("MXTPU_SERVE_QUANT", "int8"),
    ("MXTPU_TELEMETRY", ""), ("MXTPU_MAX_BAD_RECORDS", "-3"),
]


@pytest.mark.parametrize("name,raw", FLAG_CASES)
def test_flags_parse_like_jax(monkeypatch, name, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    assert penv.get_env(name) == jenv.get_env(name)
    assert type(penv.get_env(name)) is type(jenv.get_env(name))
    with pytest.raises(KeyError):
        penv.get_env("MXTPU_NOT_A_FLAG")


def test_flags_read_the_mxnet_prefix(monkeypatch):
    monkeypatch.delenv("MXTPU_CACHEDOP_CAPACITY", raising=False)
    monkeypatch.setenv("MXNET_CACHEDOP_CAPACITY", "9")
    assert penv.get_env("MXTPU_CACHEDOP_CAPACITY") == 9 == \
        jenv.get_env("MXTPU_CACHEDOP_CAPACITY")


# ------------------------------------------------------ metric registry
def _drive(t):
    t.counter("train_steps_total").inc()
    t.counter("train_steps_total").inc(4)
    t.counter("retry_attempts_total").inc()
    t.gauge("epoch").set(3)
    t.gauge("prefetch_queue_depth").set(1.5)
    h = t.histogram("span_data_wait_seconds", max_samples=8)
    for v in (0.5, 0.25, 2.0, 1.0, 0.125, 4.0, 0.75, 3.0, 8.0, 0.01):
        h.observe(v)
    t.histogram("compile_seconds").observe(1.25)


def _no_ts(snap):
    return {k: v for k, v in snap.items() if k != "ts"}


def test_prometheus_text_and_snapshot_match_jax():
    for t in TEL.values():
        _drive(t)
    assert ptel.prometheus_text() == jtel.prometheus_text()
    assert _no_ts(ptel.snapshot()) == _no_ts(jtel.snapshot())
    assert "# HELP mxtpu_train_steps_total" in ptel.prometheus_text()
    with pytest.raises(TypeError, match="already registered"):
        ptel.get_registry().gauge("train_steps_total")


def test_disabled_telemetry_is_a_no_op(monkeypatch):
    monkeypatch.setenv("MXTPU_TELEMETRY", "0")
    assert ptel.counter("x") is ptel.NULL_METRIC
    assert ptel.span("data_wait") is ptel.NULL_SPAN
    ptr.trace_event("compile", site="s")
    assert ptr.events() == [] and ptel.snapshot()["counters"] == {}
    assert ptr.compile_ledger("s").record({"shape": 1}, 0.1) == "disabled"


def test_emitter_writes_jsonl_and_prom(tmp_path):
    path = str(tmp_path / "tel.jsonl")
    em = ptel.TelemetryEmitter(path=path, interval=60.0)
    _drive(ptel)
    em.start()
    em.flush()
    em.stop()
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert len(lines) == 2 and lines[0]["counters"]["train_steps_total"] == 5
    assert open(path + ".prom").read() == ptel.prometheus_text()


def test_anomaly_watch_matches_jax():
    rs = np.random.RandomState(0)
    samples = [{"data_wait": 0.01 + 0.001 * rs.rand(),
                "forward_backward": 0.1 + 0.002 * rs.rand()}
               for _ in range(40)]
    samples[30]["data_wait"] = 0.5          # one regression episode
    out = {}
    for n, t in TEL.items():
        w = t.AnomalyWatch(window=16, threshold=6.0, min_samples=8,
                           cooldown=3)
        opened = [w.observe(s) for s in samples]
        out[n] = ([o for o in opened if o], w.verdicts(),
                  t.snapshot()["counters"])
    assert out["port"] == out["jax"]
    assert out["port"][0][0]["component"] == "data_wait"


def test_span_lands_in_the_profiler_stream():
    from incubator_mxnet_tpu_torch import profiler
    profiler._profiler.set_state("run")
    try:
        with ptel.span("data_wait") as sp:
            pass
    finally:
        profiler._profiler.set_state("stop")
    assert sp.elapsed >= 0.0
    names = [e["name"] for e in profiler._profiler._events]
    profiler._profiler._events.clear()
    assert "data_wait" in names
    assert ptel.snapshot()["histograms"][
        "span_data_wait_seconds"]["count"] == 1
    counters = profiler._profiler._counter_events()
    assert counters == [] or all(e["ph"] == "C" for e in counters)


# ------------------------------------------------------- fault injection
SPECS = [
    "", "collective:allreduce:2:hang",
    "checkpoint:save:1:truncate,record:read:*:corrupt",
    "data_service:net:3:corrupt", "data_service:host:1:kill",
    "grad:update:2:nan", "loss:check:1:spike", "mem:oom:1:error",
    "a:b:c", "a:b:1:explode", "a:b:0:error", "a:b:x:error",
    "serve:step:1:truncate", "heartbeat:beat:1:corrupt", "x::1:error",
    "serve:step:1:kill", "loss:check:1:nan", "grad:x:1:spike",
    "mem:oom:1:hang", " data:prefetch:2:error , ",
]


def _parse(mod, spec):
    try:
        return ("ok", mod.parse_fault_spec(spec))
    except ValueError as exc:
        return ("err", str(exc))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_spec_matches_jax(spec):
    assert _parse(pres, spec) == _parse(jres, spec)


def test_inject_raises_and_returns_like_jax(monkeypatch):
    monkeypatch.setenv(
        "MXTPU_FAULT_SPEC",
        "data:prefetch:2:error,checkpoint:save:*:truncate,"
        "record:read:1:corrupt")
    for r in RES.values():
        r.reset_faults()
    seen = {}
    for n, r in RES.items():
        out = []
        for scope, op in (("data", "prefetch"), ("data", "prefetch"),
                          ("checkpoint", "save"), ("record", "read"),
                          ("record", "read"), ("data", "prefetch")):
            try:
                out.append(r.inject(scope, op))
            except r.TransientError as exc:
                out.append(("TransientError", str(exc)))
        seen[n] = out
        assert r.faults_active()
    assert seen["port"] == seen["jax"]
    assert seen["port"][1][0] == "TransientError"
    assert issubclass(pres.TransientError, pres.ResilienceError)


def test_retry_policy_delays_match_jax():
    for kw in ({"jitter": 0.25}, {"jitter": True}, {"jitter": 0.0},
               {"max_retries": 7, "base_delay": 0.5, "max_delay": 3.0}):
        a = pres.RetryPolicy(seed=7, **kw).delays()
        b = jres.RetryPolicy(seed=7, **kw).delays()
        assert a == b and len(a) == kw.get("max_retries", 4)


def test_retry_and_deadline_calls():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise pres.TransientError("UNAVAILABLE")
        return "ok"
    pol = pres.RetryPolicy(max_retries=3, base_delay=0.0, jitter=0.0)
    with pytest.warns(RuntimeWarning, match="retrying"):
        assert pres.retry_call(flaky, policy=pol) == "ok"
    assert ptel.snapshot()["counters"]["retry_attempts_total"] == 2
    with pytest.raises(pres.TransientError):
        pres.call_transient_mapped(
            lambda: (_ for _ in ()).throw(OSError("connection REFUSED")))
    with pytest.raises(pres.DeadlineExceededError, match="slow_op"):
        pres.deadline_call(lambda: time.sleep(2.0), 0.1, "slow_op")
    assert pres.deadline_call(lambda: 5, 1.0) == 5


def test_atomic_write_damage_and_verify_match_jax(tmp_path):
    for n, r in RES.items():
        p = str(tmp_path / f"{n}.bin")
        r.atomic_write_bytes(p, b"payload" * 100)
        assert r.verify_checkpoint(p, require_sidecar=True)
        r.damage_file(p, "corrupt")
        assert not r.verify_checkpoint(p)
        with pytest.raises(r.CheckpointCorruptError):
            r.validate_or_raise(p)
    assert open(str(tmp_path / "port.bin.crc32")).read() == \
        open(str(tmp_path / "jax.bin.crc32")).read()


def test_heartbeat_carries_the_snapshot(tmp_path):
    path = str(tmp_path / "hb")
    ptel.counter("train_steps_total").inc(2)
    assert pres.start_heartbeat(path, interval=0.05) == path
    deadline = time.monotonic() + 5
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.02)
    pres.stop_heartbeat()
    first, second = open(path).read().splitlines()[:2]
    assert float(first) > 0
    assert json.loads(second)["counters"]["train_steps_total"] == 2
    assert pres.heartbeat_age() is not None


# ------------------------------------------------------------------ rpc
MSGS = [({"op": "ping"}, 0.0), ({"op": "batch", "shard": 2, "data": "QUJD",
                                 "seq": [1, 2.5, None]}, 1.75),
        ({"op": "epoch", "cmd": {"order": list(range(20))},
          "why": "ü"}, 3.0)]


@pytest.mark.parametrize("msg,budget", MSGS)
def test_encode_frame_bytes_match_jax(msg, budget):
    assert prpc.encode_frame(msg, budget) == jrpc.encode_frame(msg, budget)


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_rpc_client_and_server_across_packages(server_pkg):
    srv_mod, cli_mod = (jrpc, prpc) if server_pkg == "jax" \
        else (prpc, jrpc)

    def handler(msg, conn, budget):
        return {"op": "echo", "got": msg, "budget": budget}
    srv = srv_mod.RpcServer(handler, port=0, name="t", poll=0.05,
                            fault_scope=None).start()
    try:
        cli = cli_mod.RpcClient("127.0.0.1", srv.port, timeout=5,
                                fault_scope=None).connect()
        reply, _ = cli.call({"op": "hi", "n": 3}, budget=2.0)
        cli.close()
        assert reply == {"op": "echo", "got": {"op": "hi", "n": 3},
                         "budget": 2.0}
        reply, _ = cli_mod.call_once("127.0.0.1", srv.port,
                                     {"op": "x"}, timeout=5)
        assert reply["got"] == {"op": "x"}
    finally:
        srv.close()


def test_garbled_frame_poisons_the_connection(monkeypatch):
    got = []
    srv = prpc.RpcServer(lambda m, c, b: got.append(m), port=0, poll=0.05,
                         fault_scope=None).start()
    monkeypatch.setenv("MXTPU_FAULT_SPEC", "router:net:1:corrupt")
    pres.reset_faults()
    errors0 = prpc._m_frame_errors.value   # resolved at import
    try:
        cli = prpc.RpcClient("127.0.0.1", srv.port, timeout=5).connect()
        cli.send({"op": "a"})                 # garbled: dropped
        deadline = time.monotonic() + 5
        while srv.connections() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not srv.connections() and got == []
        cli.close()
        cli.connect()
        cli.send({"op": "b"})                 # a fresh link is clean
        deadline = time.monotonic() + 5
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        assert got == [{"op": "b"}]
        assert prpc._m_frame_errors.value == errors0 + 1
    finally:
        cli.close()
        srv.close()


def test_rpc_waits_are_bounded():
    import socket
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    try:
        cli = prpc.RpcClient("127.0.0.1", lsock.getsockname()[1],
                             timeout=0.3).connect()
        t0 = time.monotonic()
        with pytest.raises(prpc.RpcTimeoutError):
            cli.call({"op": "ping"})          # nobody answers
        assert time.monotonic() - t0 < 3
        cli.close()
    finally:
        lsock.close()


# --------------------------------------------------------------- debugz
def test_debugz_answers_a_jax_client():
    srv = pdebugz.DebugzServer("data").start()
    try:
        pdebugz.publish("train", step=3)
        pdebugz.register_provider("shards", lambda: {"n": 2})
        ptel.counter("train_steps_total").inc()
        replies = {op: jrpc.call_once("127.0.0.1", srv.port, {"op": op},
                                      timeout=5)[0]
                   for op in ("varz", "statusz", "tracez", "memz",
                              "healthz", "nope")}
    finally:
        srv.close()
    assert replies["varz"]["telemetry"]["counters"] == \
        {"train_steps_total": 1}
    assert replies["statusz"]["status"] == {"train": {"step": 3},
                                            "shards": {"n": 2}}
    assert replies["healthz"]["ok"] is True
    assert set(replies["memz"]["memory"]) == {"host_rss_bytes"}
    assert replies["nope"]["op"] == "error"
    assert {r["role"] for r in replies.values() if "role" in r} == {"data"}


def test_debugz_maybe_start_writes_the_port_file(monkeypatch, tmp_path):
    pf = str(tmp_path / "port")
    monkeypatch.setenv("MXTPU_DEBUGZ_PORTFILE", pf)
    srv = pdebugz.maybe_start("train")
    assert srv is pdebugz.maybe_start("train") is pdebugz.server()
    assert open(pf).read().strip() == f"{srv.host}:{srv.port}"
    pdebugz.stop()
    monkeypatch.setenv("MXTPU_DEBUGZ", "0")
    assert pdebugz.maybe_start("train") is None


# -------------------------------------------------------------- tracing
def test_flight_recorder_dump_and_stitch_match_jax(tmp_path):
    dumps = {}
    for n, t in TR.items():
        t.trace_event("data_service_worker_dead", shard=1, exitcode=-9)
        t.trace_event("data_service_worker_restart", shard=1, restart=1)
        assert [e["event"] for e in t.events()] == [
            "data_service_worker_dead", "data_service_worker_restart"]
        assert t.events("data_service_worker_restart", shard=1)
        dumps[n] = t.dump(str(tmp_path / f"{n}.jsonl"), reason="test")
    strip = [{k: v for k, v in e.items() if k not in ("ts", "src")}
             for e in ptr.stitch_dumps([dumps["port"]])]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "src")}
                     for e in jtr.stitch_dumps([dumps["jax"]])]
    head = json.loads(open(dumps["port"]).readline())
    assert head["flight_recorder"] == 1 and head["events"] == 2


def test_compile_ledger_attribution_matches_jax():
    sigs = [{"shape": (2, 3), "dtype": "f32", "train_flag": True},
            {"shape": (4, 3), "dtype": "f32", "train_flag": True},
            {"shape": (4, 3), "dtype": "f16", "train_flag": False},
            {"shape": (2, 3), "dtype": "f32", "train_flag": True}]
    got = {n: [t.compile_ledger("site").record(s, 0.5) for s in sigs]
           for n, t in TR.items()}
    assert got["port"] == got["jax"] == [
        "first_compile", "shape", "dtype+train_flag", "duplicate"]
    assert ptr.compile_totals() == jtr.compile_totals() == (4, 2.0)
    assert ptel.snapshot()["counters"]["compile_events_total"] == 4


def test_device_memory_stats_never_initializes_cuda():
    import torch
    stats = ptr.device_memory_stats()
    if not torch.cuda.is_initialized():
        assert set(stats) == {"host_rss_bytes"}
    assert stats["host_rss_bytes"] > 0
    assert not torch.cuda.is_initialized() or torch.cuda.is_available()
    ptr.update_memory_gauges()
    assert ptel.snapshot()["gauges"]["host_rss_bytes"] > 0


def test_locks_are_fresh_in_a_forked_child():
    """A child forked while another thread holds the registry's, the
    recorder's and the fault-injection locks takes none of them."""
    ptr.trace_event("anomaly", group="t")
    held = [ptel.get_registry()._lock, ptr.get_recorder()._lock,
            pres._FAULT_LOCK]
    for lk in held:
        lk.acquire()
    try:
        pid = os.fork()
        if pid == 0:                      # child: must not block
            try:
                signal.alarm(10)
                ptel.counter("train_steps_total").inc()
                ptr.trace_event("anomaly", group="child")
                pres.fault_for("data", "prefetch")
                os._exit(0 if ptel.counter(
                    "train_steps_total").value == 1 else 3)
            except BaseException:
                os._exit(4)
        _, status = os.waitpid(pid, 0)
    finally:
        for lk in held:
            lk.release()
    assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0


# ------------------------------------------------------------ fit spans
def _fit(M, tel):
    S = M.sym
    x = S.FullyConnected(S.Variable("data"), num_hidden=8, name="fc1")
    x = S.Activation(x, act_type="relu")
    x = S.FullyConnected(x, num_hidden=3, name="fc2")
    net = S.SoftmaxOutput(x, name="softmax")
    rs = np.random.RandomState(0)
    data = rs.rand(16, 5).astype(np.float32)
    label = rs.randint(0, 3, 16).astype(np.float32)
    it = M.io.NDArrayIter(data, label, batch_size=4)
    ctx = M.cpu()
    mod = M.mod.Module(net, context=ctx)
    tel.get_registry().reset()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1),),
            initializer=M.init.Xavier(),
            batch_end_callback=M.callback.Speedometer(4, frequent=2))
    snap = tel.snapshot()
    return (snap["counters"],
            {k: v["count"] for k, v in snap["histograms"].items()},
            sorted(snap["gauges"]))


def test_fit_spans_and_counters_match_jax():
    ref = _fit(mx, jtel)
    port = _fit(mt, ptel)
    assert port[:2] == ref[:2]
    # the gauges too: the perf observatory's and the memory planner's
    # (train_mfu, train_mbu, train_tokens_per_sec, memory_plan_peak_bytes)
    assert set(port[2]) == set(ref[2])
    counters, hists, _ = port
    assert counters["train_steps_total"] == 4
    for name in ("data_wait", "forward_backward", "optimizer",
                 "host_sync"):
        assert hists[f"span_{name}_seconds"] == 4 + (name == "data_wait")


def test_cachedop_counts_and_ledger():
    net = mt.gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=mt.cpu())
    net.hybridize()
    for shape in ((2, 3), (2, 3), (5, 3)):
        net(mt.nd.ones(shape, ctx=mt.cpu()))
    c = ptel.snapshot()["counters"]
    assert (c["cachedop_cache_hits_total"],
            c["cachedop_cache_misses_total"]) == (1, 2)
    reasons = [e["reason"] for e in ptr.events("compile")]
    assert reasons == ["first_compile", "shape"]
