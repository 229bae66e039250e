"""The port's serving engine (incubator_mxnet_tpu_torch/serving/) on the
CPU, at the JAX serving tests' tiny width (vocab 37, d_model 32, 2
layers, 4 heads, max_len 64).

Twins of the engine tests of ``tests/test_serving.py`` and of a chosen
set of ``tests/test_serving_slo.py`` (deadlines, cancellation, stream
abandon, admission control, drain, snapshot/restore), on the port's own
model.  Then cross-package parity: the JAX ``ServingEngine`` and the
port's, over one JAX model's weights carried with
``convert.load_reference_weights``, stepped in lockstep on the same
prompts with the same settings: identical greedy tokens, block ids and
prefix-cache hits, ``keep_logits`` rows within rtol 1e-4, atol 1e-5
(fp32 on the CPU, sums in another order), and a snapshot file the JAX
engine wrote restores in the port's engine and finishes token-identical.

Not here (their mechanisms are not ported yet): fault injection,
telemetry counters and trace events, the step watchdog and SIGTERM.
"""
import gc
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
from incubator_mxnet_tpu import serving as jserving  # noqa: E402
from incubator_mxnet_tpu import telemetry  # noqa: E402
from incubator_mxnet_tpu.gluon.model_zoo import transformer as jtr  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch import resilience  # noqa: E402
from incubator_mxnet_tpu_torch.convert import load_reference_weights  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.transformer import (  # noqa: E402
    TransformerLM)
from incubator_mxnet_tpu_torch.serving import (  # noqa: E402
    CANCELLED, EXPIRED, FINISHED, BlockPool, BlockPoolExhausted,
    PrefixCache, RequestTooLargeError, ServeRejectedError, ServingEngine,
    ServingError, quantization_error, quantize_weights, weights_nbytes)
from torch_port_threads import one_intra_op_thread  # noqa: E402,F401

VOCAB = 37
CFG = dict(d_model=32, n_layers=2, n_heads=4, max_len=64)
_NETS = {}


def _tiny(**kw):
    """The port's tiny LM, seeded Xavier weights, built once per
    config (engines never change the model)."""
    key = tuple(sorted(kw.items()))
    if key not in _NETS:
        cfg = dict(CFG, **kw)
        net = TransformerLM(VOCAB, **cfg, device="cpu")
        mt.initializer.initialize(net, mt.initializer.Xavier(),
                                  mt.random.generator(0))
        _NETS[key] = net
    return _NETS[key]


def _gen_ref(net, prompt, max_new):
    """Sequential one-request-at-a-time generate() reference."""
    out = net.generate(torch.tensor([prompt]), max_new)
    return [int(t) for t in out[0]]


def _engine(net=None, **kw):
    cfg = dict(max_batch=1, block_size=4, num_blocks=64,
               prefix_cache=False)
    cfg.update(kw)
    return ServingEngine(net if net is not None else _tiny(), **cfg)


# ------------------------------------------------------------ block pool
def test_block_pool_alloc_free_refcount():
    pool = BlockPool(num_blocks=8, block_size=4)
    assert pool.capacity == 7 and pool.num_free == 7
    a = pool.alloc(3)
    assert len(set(a)) == 3 and 0 not in a
    assert pool.num_allocated == 3
    assert all(pool.refcount(b) == 1 for b in a)
    pool.incref(a[:1])
    assert pool.refcount(a[0]) == 2
    pool.free(a)                       # a[0] survives via the incref
    assert pool.refcount(a[0]) == 1
    assert pool.num_allocated == 1
    pool.free(a[:1])
    assert pool.num_free == 7
    assert pool.utilization() == 0.0


def test_block_pool_double_free_and_exhaustion():
    pool = BlockPool(num_blocks=4, block_size=2)
    a = pool.alloc(3)
    with pytest.raises(BlockPoolExhausted):
        pool.alloc(1)
    pool.free(a[:1])
    with pytest.raises(ValueError, match="double free"):
        pool.free(a[:1])
    with pytest.raises(ValueError, match="incref on free"):
        pool.incref(a[:1])
    free_before = pool.num_free         # all-or-nothing alloc
    with pytest.raises(BlockPoolExhausted):
        pool.alloc(free_before + 1)
    assert pool.num_free == free_before


# ---------------------------------------------------------- prefix cache
def test_prefix_cache_match_insert_evict():
    pool = BlockPool(num_blocks=16, block_size=4)
    cache = PrefixCache(pool)
    toks = list(range(10))             # 2 full blocks + remainder
    blocks = pool.alloc(3)
    assert cache.insert(toks, blocks) == 2
    assert pool.refcount(blocks[0]) == 2
    m, n = cache.match(toks)
    assert m == blocks[:2] and n == 8
    assert pool.refcount(blocks[0]) == 3
    pool.free(m)
    m, n = cache.match(toks[:8])       # the last token stays suffix
    assert m == blocks[:1] and n == 4
    pool.free(m)
    m, n = cache.match([5] * 12)       # another history: no match
    assert m == [] and n == 0
    pool.free(blocks)                  # the request lets go
    assert cache.evict(5) == 2
    assert len(cache) == 0 and pool.num_free == pool.capacity


# ------------------------------------------- equivalence with generate()
def test_continuous_batching_matches_sequential_generate():
    net = _tiny()
    rs = np.random.RandomState(3)
    prompts = [list(rs.randint(0, VOCAB, n)) for n in (4, 9, 6, 13)]
    refs = [_gen_ref(net, p, 11) for p in prompts]
    eng = _engine(max_batch=2, prefix_cache=True)
    reqs = [eng.submit(p, 11) for p in prompts]
    out = eng.run()
    for req, ref in zip(reqs, refs):
        assert req.state == FINISHED
        assert req.tokens == ref
        assert out[req.id] == req.tokens
    assert all(r.block_ids == [] for r in reqs)
    assert eng.pool.live() == eng.cache.block_refs()


def test_rope_gqa_model_matches_generate():
    net = _tiny(pos="rope", n_kv_heads=2)
    rs = np.random.RandomState(5)
    prompts = [list(rs.randint(0, VOCAB, n)) for n in (5, 8)]
    refs = [_gen_ref(net, p, 9) for p in prompts]
    eng = _engine(net, max_batch=2, prefix_cache=True)
    reqs = [eng.submit(p, 9) for p in prompts]
    eng.run()
    assert [r.tokens for r in reqs] == refs


def test_eos_stops_early_and_frees_blocks():
    net = _tiny()
    prompt = list(np.random.RandomState(7).randint(0, VOCAB, 6))
    ref = _gen_ref(net, prompt, 12)
    eos = ref[len(prompt) + 3]         # stop at the 4th new token
    eng = _engine(num_blocks=32)
    req = eng.submit(prompt, 12, eos_id=eos)
    eng.run()
    assert req.state == FINISHED
    assert req.generated[-1] == eos and len(req.generated) <= 12
    assert req.tokens == ref[:len(req.tokens)]
    assert eng.pool.num_allocated == 0


def test_admission_retirement_never_rebuild():
    rs = np.random.RandomState(11)
    # one pow2 prefill bucket (5..8 tokens) for every request
    prompts = [list(rs.randint(0, VOCAB, n)) for n in (5, 6, 7, 8, 5, 6)]
    eng = _engine(max_batch=2)
    for p in prompts[:4]:
        eng.submit(p, 7)
    eng.run()
    assert eng.trace_counts == {"prefill_8": 1, "decode": 1}
    for p in prompts[4:]:              # a second wave replays both
        eng.submit(p, 5)
    eng.run()
    assert eng.trace_counts == {"prefill_8": 1, "decode": 1}


# -------------------------------------------------------- prefix caching
def test_prefix_cache_reuse_is_copy_free_and_exact():
    net = _tiny()
    rs = np.random.RandomState(13)
    system = list(rs.randint(0, VOCAB, 12))    # 3 full blocks @ bs=4
    prompts = [system + list(rs.randint(0, VOCAB, n)) for n in (3, 6, 2)]
    refs = [_gen_ref(net, p, 8) for p in prompts]
    eng = _engine(prefix_cache=True)
    reqs = []
    for p in prompts:                 # sequential: warm, then reuse
        reqs.append(eng.submit(p, 8))
        eng.run()
    assert [r.tokens for r in reqs] == refs
    assert eng.stats()["prefix_hit_tokens"] >= 24
    assert len(eng.cache) >= 3
    eng2 = _engine()                  # correctness does not need sharing
    r2 = eng2.submit(prompts[1], 8)
    eng2.run()
    assert r2.tokens == refs[1]


def test_prefix_cache_blocks_shared_between_live_requests():
    net = _tiny()
    system = list(np.random.RandomState(17).randint(0, VOCAB, 8))
    eng = _engine(max_batch=2, prefix_cache=True)
    r1 = eng.submit(system + [1, 2, 3], 4)
    eng.step()                                 # admit + first token
    r2 = eng.submit(system + [4, 5], 4)
    eng.step()
    shared = set(r1.block_ids[:2]) & set(r2.block_ids[:2])
    assert len(shared) == 2                    # same physical blocks
    for b in shared:
        assert eng.pool.refcount(b) >= 3       # r1 + r2 + cache
    eng.run()
    assert r1.tokens == _gen_ref(net, r1.prompt, 4)
    assert r2.tokens == _gen_ref(net, r2.prompt, 4)


# ------------------------------------------------ preemption + requeue
def test_pool_exhaustion_preempts_and_requeues():
    net = _tiny()
    rs = np.random.RandomState(19)
    prompts = [list(rs.randint(0, VOCAB, n)) for n in (9, 10)]
    refs = [_gen_ref(net, p, 14) for p in prompts]
    # too small a pool for both full sequences: one is preempted
    eng = _engine(max_batch=2, num_blocks=12)
    reqs = [eng.submit(p, 14) for p in prompts]
    eng.run()
    assert sum(r.preemptions for r in reqs) >= 1
    assert [r.state for r in reqs] == [FINISHED, FINISHED]
    assert [r.tokens for r in reqs] == refs
    assert eng.pool.num_allocated == 0


def test_single_request_too_big_for_pool_raises():
    eng = _engine(num_blocks=4)
    with pytest.raises(ValueError, match="needs .* blocks"):
        eng.submit(list(range(10)), 8)


# -------------------------------------------------------- quantization
def test_int8_quantization_density_and_logit_tolerance():
    net = _tiny()
    wts = net._decode_params()
    qwts = quantize_weights(wts)
    assert weights_nbytes(qwts) < 0.5 * weights_nbytes(wts)
    assert quantization_error(wts, qwts) <= 1 / 127 + 1e-6
    prompt = list(np.random.RandomState(29).randint(0, VOCAB, 9))
    logits = {}
    for mode in ("off", "int8"):
        eng = _engine(quantize=mode, keep_logits=True)
        # max_new=1: logits over the SAME context
        req = eng.submit(prompt, 1)
        eng.run()
        logits[mode] = req.logits.numpy()
    scale = np.abs(logits["off"]).max()
    assert np.abs(logits["int8"] - logits["off"]).max() <= 0.05 * scale
    with pytest.raises(ValueError, match="quantize"):
        _engine(quantize="int4")


# ------------------------------------------------------- API validation
def test_submit_validation_and_stream():
    eng = _engine(max_batch=2)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2], 0)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(60)), 20)
    req = eng.submit(torch.tensor([1, 2, 3]), 5)
    events = list(eng.stream())
    assert [t for r, t in events if r is req] == req.generated
    assert len(req.generated) == 5
    assert not eng.has_work()


def test_engine_rejects_unsupported_models_and_unported_options():
    with pytest.raises(NotImplementedError, match="window"):
        _engine(_tiny(attn_window=4))
    with pytest.raises(TypeError, match="TransformerLM"):
        ServingEngine(object(), max_batch=1)
    moe = TransformerLM(VOCAB, **CFG, device="cpu")
    moe.moe_experts = 2   # the guard reads the flag before any weight
    with pytest.raises(NotImplementedError, match="MoE"):
        _engine(moe)
    with pytest.raises(NotImplementedError, match="auto"):
        _engine(num_blocks="auto")
    with pytest.raises(NotImplementedError, match="watchdog"):
        _engine(step_timeout=1.0)


def test_engine_defaults_come_from_the_environment(monkeypatch):
    eng = ServingEngine(_tiny())
    assert (eng.max_batch, eng.block_size, eng.num_blocks,
            eng.cache.enabled, eng.quantized) == (8, 16, 512, True, False)
    monkeypatch.setenv("MXTPU_SERVE_MAX_BATCH", "3")
    monkeypatch.setenv("MXNET_SERVE_BLOCK_SIZE", "8")  # the fallback
    monkeypatch.setenv("MXTPU_SERVE_PREFIX_CACHE", "0")
    monkeypatch.setenv("MXTPU_SERVE_NUM_BLOCKS", "auto")  # int() fails
    eng = ServingEngine(_tiny())
    assert (eng.max_batch, eng.block_size, eng.num_blocks,
            eng.cache.enabled) == (3, 8, 512, False)


def test_decode_flops_per_token_matches_jax():
    net = jtr.TransformerLM(VOCAB, **CFG, n_kv_heads=2)
    port = _tiny(n_kv_heads=2)
    for ctx in (1, 17, 64):
        assert port.decode_flops_per_token(ctx) == \
            net.decode_flops_per_token(ctx)


# ----------------------------------------------------- deadlines (SLO)
def test_ttft_deadline_expires_queued_request_without_leaks():
    net = _tiny()
    rs = np.random.RandomState(41)
    prompts = [list(rs.randint(0, VOCAB, n)) for n in (8, 6)]
    eng = _engine()
    r1 = eng.submit(prompts[0], 10)
    # queued behind r1 in the only slot: a millisecond TTFT budget
    # cannot survive one decode iteration
    r2 = eng.submit(prompts[1], 10, ttft_deadline=1e-3)
    time.sleep(2e-3)
    out = eng.run()
    assert r1.state == FINISHED and r1.tokens == _gen_ref(net,
                                                          prompts[0], 10)
    assert r2.state == EXPIRED
    assert isinstance(r2.error, resilience.DeadlineExceededError)
    assert r2.generated == [] and r2.id in out
    assert eng.pool.num_allocated == 0
    assert eng.stats()["terminal_counts"][EXPIRED] == 1


def test_total_deadline_expires_midstream_retaining_output():
    eng = _engine()
    req = eng.submit([3, 1, 4, 1, 5], 20, deadline=60.0)
    for _ in range(4):
        eng.step()
    n_before = len(req.generated)
    assert 0 < n_before < 20
    # force the breach: rewind the stamp AND the earliest-deadline gate
    req.deadline_ts = time.monotonic() - 1.0
    eng._deadline_next = 0.0
    eng.run()
    assert req.state == EXPIRED
    assert len(req.generated) == n_before
    assert eng.pool.num_allocated == 0


# ------------------------------------------------------ cancellation
def test_cancel_queued_and_running_requests():
    net = _tiny()
    rs = np.random.RandomState(43)
    prompts = [list(rs.randint(0, VOCAB, n)) for n in (7, 5)]
    ref0 = _gen_ref(net, prompts[0], 8)
    eng = _engine()
    r1 = eng.submit(prompts[0], 8)
    r2 = eng.submit(prompts[1], 8)          # queued behind r1
    assert eng.cancel(r2.id) is True
    assert eng.cancel(r2.id) is False       # already marked
    assert eng.cancel(999) is False         # unknown id
    eng.step()                              # r1 admitted; r2 reaped
    assert r2.state == CANCELLED
    eng.step()
    assert eng.cancel(r1.id) is True        # a RUNNING request
    eng.run()
    assert r1.state == CANCELLED
    assert 0 < len(r1.generated) < 8
    assert r1.tokens == ref0[:len(r1.tokens)]
    assert eng.pool.num_allocated == 0
    assert eng.stats()["terminal_counts"][CANCELLED] == 2
    assert eng.cancel(r1.id) is False       # terminal: not live


def test_stream_abandon_cancels_request():
    eng = _engine()
    req = eng.submit([2, 7, 1, 8], 12)
    got = []
    for tok in eng.stream_request(req):
        got.append(tok)
        if len(got) == 3:
            break                       # the client hangs up
    assert req.cancel_requested and not req.done
    eng.step()
    assert req.state == CANCELLED and req.generated[:3] == got
    assert eng.pool.num_allocated == 0 and not eng.has_work()
    r2 = eng.submit([5, 5, 6], 4)       # a full consumption: no cancel
    assert len(list(eng.stream_request(r2))) == 4
    assert r2.state == FINISHED
    r3 = eng.submit([9, 8, 7], 5)       # dropped before its first next()
    gen = eng.stream_request(r3)
    del gen
    gc.collect()
    eng.step()
    assert r3.state == CANCELLED and eng._cancels_pending == 0


# ------------------------------------------- admission control/shed
def test_queue_limit_sheds_with_typed_error():
    eng = _engine(queue_limit=2)
    reqs = [eng.submit([1, 2, 3], 2) for _ in range(2)]
    with pytest.raises(ServeRejectedError, match="queue_limit"):
        eng.submit([1, 2, 3], 2)
    assert isinstance(ServeRejectedError("x"), ServingError)
    assert eng.stats()["terminal_counts"]["rejected"] == 1
    eng.run()
    assert all(r.state == FINISHED for r in reqs)


def test_queued_token_budget_sheds():
    eng = _engine(queue_tokens=10)
    eng.submit(list(range(1, 9)), 2)            # 8 queued tokens
    with pytest.raises(ServeRejectedError, match="queue_tokens"):
        eng.submit(list(range(1, 9)), 2)        # would make 16
    eng.submit([1, 2], 2)                       # 10: still fits
    eng.run()
    assert eng._sched.queued_tokens == 0
    eng = _engine(num_blocks=4)                 # never servable: typed
    with pytest.raises(RequestTooLargeError, match="blocks"):
        eng.submit(list(range(10)), 8)
    with pytest.raises(RequestTooLargeError, match="max_len"):
        eng.submit(list(range(30)), 40)
    assert not eng.has_work()


# --------------------------------------------------- drain/snapshot
def test_drain_stops_admission_finishes_running():
    net = _tiny()
    rs = np.random.RandomState(47)
    prompts = [list(rs.randint(0, VOCAB, n)) for n in (6, 9, 5)]
    refs = [_gen_ref(net, p, 7) for p in prompts]
    eng = _engine()
    reqs = [eng.submit(p, 7) for p in prompts]
    eng.step()                          # admit + first token for r0
    done = eng.drain()
    assert eng.drain() == {}            # idempotent
    assert reqs[0].state == FINISHED and reqs[0].id in done
    assert reqs[0].tokens == refs[0]
    assert [r.state for r in reqs[1:]] == ["queued", "queued"]
    with pytest.raises(ServeRejectedError, match="draining"):
        eng.submit([1, 2], 2)
    assert eng.run() == {} and not eng.has_work()
    snap = eng.snapshot()
    assert sorted(e["id"] for e in snap["requests"]) == \
        sorted(r.id for r in reqs[1:])
    eng2 = ServingEngine.restore(net, snap)
    out = eng2.run()
    assert out[reqs[1].id] == refs[1] and out[reqs[2].id] == refs[2]
    assert eng2.pool.num_allocated == 0


def test_snapshot_restore_mid_decode_token_identical(tmp_path):
    net = _tiny()
    rs = np.random.RandomState(53)
    prompts = [list(rs.randint(0, VOCAB, n)) for n in (4, 11, 7)]
    refs = [_gen_ref(net, p, 13) for p in prompts]
    eng = _engine(max_batch=2)
    reqs = [eng.submit(p, 13, deadline=600.0) for p in prompts]
    for _ in range(5):
        eng.step()                      # mid-decode state
    path = str(tmp_path / "serve.snap")
    snap = eng.snapshot(path)
    assert os.path.exists(path) and os.path.exists(path + ".crc32")
    assert [e["id"] for e in snap["requests"]] == [r.id for r in reqs]
    assert all(e["deadline_remaining_s"] > 0 for e in snap["requests"])
    eng2 = ServingEngine.restore(net, path)
    out = eng2.run()
    assert [out[r.id] for r in reqs] == refs
    assert eng2.pool.num_allocated == 0
    assert eng2._next_id == eng._next_id


def test_corrupt_snapshot_raises_typed(tmp_path):
    eng = _engine(num_blocks=32)
    eng.submit([1, 2, 3], 2)
    path = str(tmp_path / "serve.snap")
    eng.snapshot(path)
    with open(path, "r+b") as f:        # flip a byte
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(resilience.CheckpointCorruptError):
        ServingEngine.restore(_tiny(), path)
    with pytest.raises(resilience.CheckpointCorruptError):
        ServingEngine.restore(_tiny(), {"version": 99})
    eng.run()


def test_snapshot_captures_in_transit_request():
    eng = _engine()
    req = eng.submit([1, 2, 3], 2)
    popped = eng._sched.pop_waiting()   # as if mid-_admit
    eng._in_transit = popped
    assert [e["id"] for e in eng.snapshot()["requests"]] == [req.id]
    eng._sched.push_front(popped)       # landed back: no duplicate
    assert [e["id"] for e in eng.snapshot()["requests"]] == [req.id]
    eng._in_transit = None
    eng.run()
    assert req.state == FINISHED


# ------------------------------------------------ cross-package parity
_JAX = {}


def _jax_pair():
    """(JAX tiny LM, the port's LM with its weights), built once."""
    if not _JAX:
        mx.random.seed(0)
        net = jtr.TransformerLM(VOCAB, **CFG)
        net.initialize(mx.initializer.Xavier())
        net(mx.nd.array(np.zeros((1, 2), np.int32)))   # settles shapes
        wts = jax.tree_util.tree_map(np.asarray, net._decode_weights())
        port = TransformerLM(VOCAB, **CFG, device="cpu")
        _JAX.update(net=net, wts=wts,
                    port=load_reference_weights(port, wts))
    return _JAX["net"], _JAX["port"]


def _hits():
    return telemetry.get_registry().counter(
        "serving_prefix_cache_hits_total").value


def test_engines_match_jax_engine_in_lockstep(tmp_path):
    """Both engines on the same prompts (a shared 8-token system
    prompt, two blocks), stepped together: the same events, block ids,
    prefix hits and logits at every iteration; then a snapshot the JAX
    engine wrote mid-decode restores in the port's and finishes with
    the JAX engine's tokens."""
    net, port = _jax_pair()
    rs = np.random.RandomState(61)
    system = list(rs.randint(0, VOCAB, 8))
    prompts = [system + list(rs.randint(0, VOCAB, n)) for n in (3, 5)] \
        + [list(rs.randint(0, VOCAB, n)) for n in (6, 2)]
    cfg = dict(max_batch=2, block_size=4, num_blocks=16,
               prefix_cache=True, keep_logits=True)
    jeng = jserving.ServingEngine(net, **cfg)
    peng = ServingEngine(port, **cfg)
    hits0 = _hits()
    jreqs = [jeng.submit(p, 9) for p in prompts]
    preqs = [peng.submit(p, 9) for p in prompts]
    path = str(tmp_path / "jax.snap")
    it = 0
    while jeng.has_work():
        jev, pev = jeng.step(), peng.step()
        assert [(r.id, t) for r, t in pev] == \
            [(r.id, int(t)) for r, t in jev]
        for jr, pr in zip(jreqs, preqs):
            assert pr.state == jr.state and pr.block_ids == jr.block_ids
            assert pr.preemptions == jr.preemptions
        for (jr, _), (pr, _) in zip(jev, pev):
            np.testing.assert_allclose(pr.logits.numpy(),
                                       np.asarray(jr.logits),
                                       rtol=1e-4, atol=1e-5)
        it += 1
        if it == 4:
            snap = jeng.snapshot(path)       # mid-decode, on disk
            assert len(snap["requests"]) >= 2
    assert not peng.has_work()
    assert [r.tokens for r in preqs] == \
        [[int(t) for t in r.tokens] for r in jreqs]
    assert peng.stats()["prefix_hit_tokens"] == _hits() - hits0 > 0
    assert peng.pool.live() == jeng.pool.live() == peng.cache.block_refs()
    # the JAX engine's snapshot file, restored in the port's engine
    eng = ServingEngine.restore(port, path)
    assert eng.max_batch == 2 and eng.num_blocks == 16
    out = eng.run()
    for entry in snap["requests"]:
        rid = entry["id"]
        assert out[rid] == [int(t) for t in jreqs[rid].tokens]
    assert eng.pool.live() == eng.cache.block_refs()


def test_snapshot_written_by_the_port_restores_in_jax(tmp_path):
    net, port = _jax_pair()
    eng = ServingEngine(port, max_batch=2, block_size=4, num_blocks=16,
                        prefix_cache=False)
    reqs = [eng.submit([1, 2, 3, 4, 5], 6), eng.submit([6, 7, 8], 6)]
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "port.snap")
    eng.snapshot(path)
    eng.run()
    out = jserving.ServingEngine.restore(net, path).run()
    assert {k: [int(t) for t in v] for k, v in out.items()} == \
        {r.id: r.tokens for r in reqs}


def test_quantize_matches_jax():
    _, port = _jax_pair()
    jq = jserving.quantize_weights(_JAX["wts"])
    pq = quantize_weights(port._decode_params())
    np.testing.assert_array_equal(pq["head"]["q"].numpy(),
                                  np.asarray(jq["head"]["q"]))
    np.testing.assert_allclose(pq["layers"][1]["up"][0]["s"].numpy(),
                               np.asarray(jq["layers"][1]["up"][0]["s"]),
                               rtol=1e-7)
    assert weights_nbytes(pq) == jserving.weights_nbytes(jq)
    assert quantization_error(port._decode_params(), pq) == pytest.approx(
        jserving.quantization_error(_JAX["wts"], jq), rel=1e-5)
