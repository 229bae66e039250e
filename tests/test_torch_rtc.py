"""The port's ``rtc`` facade (incubator_mxnet_tpu_torch/rtc.py) and its
four user kernels (rtc_examples.py, csrc/rtc/*.cu) against the JAX
package's ``rtc``.

Twins of the eight tests of ``tests/test_rtc.py`` that need no ``sym``
or Gluon: on the CPU a compiled kernel runs its plain version
(``reference``), the port's counterpart of Pallas interpret mode.  Then
the signature parse and the generated launcher, which no CPU can build;
a CUDA call with no card, which raises and never runs the plain version;
the four kernels' plain versions and VJPs against the JAX kernels in
interpret mode at their own shapes; and the rtc path of ``chip_smoke.py``
(an SGD loop through ``scale_shift_relu``) at a small size against the
same loop in the JAX package.

Tolerances: x * alpha and x + 1 round once in every version, so they
are held bit for bit.  x * alpha + beta may be one FMA or two roundings:
2 ulp of |x * alpha| + |beta|, which bounds the gap even where the sum
cancels.  The loop: fp32 rel 1e-5 (sums of 8 products in another order).
"""
import ctypes
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import incubator_mxnet_tpu as mx  # noqa: E402
import incubator_mxnet_tpu_torch as mt  # noqa: E402
from incubator_mxnet_tpu_torch import autograd, nd, rtc  # noqa: E402
from incubator_mxnet_tpu_torch import rtc_examples as ex  # noqa: E402
from incubator_mxnet_tpu_torch.ops import _build  # noqa: E402
from incubator_mxnet_tpu_torch.ops import flash as tflash  # noqa: E402
from incubator_mxnet_tpu_torch.ops.registry import OPS  # noqa: E402

CPU = mt.cpu()


def _arr(a):
    return nd.array(np.asarray(a, np.float32), ctx=CPU)


@pytest.fixture
def scale_op():
    fn = ex.kernel("scale")
    rtc.register(
        "test_rtc_scale", fn, arg_names=["data"],
        vjp=(lambda x, alpha=2.0: (fn(x, alpha=alpha), None),
             lambda alpha, res, g: (g * (alpha * 10),)))
    # deliberately wrong-by-10x gradient proves the custom VJP (not
    # autodiff through the kernel) is what backward uses
    yield
    rtc.unregister("test_rtc_scale")


# ------------------------------------------------ twins of test_rtc.py

def test_eager_and_grad(scale_op):
    x = _arr(np.arange(6).reshape(2, 3))
    y = nd.test_rtc_scale(x, alpha=3.0)
    np.testing.assert_allclose(y.asnumpy(), x.asnumpy() * 3.0)

    x.attach_grad()
    with autograd.record():
        y = nd.test_rtc_scale(x, alpha=3.0)
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), np.full((2, 3), 30.0))
    # the gradient is a torch.autograd.Function's
    with autograd.record():
        y = nd.test_rtc_scale(x, alpha=3.0)
    assert type(y.handle.grad_fn).__name__ == "_CustomVJPBackward"


def test_register_plain_torch_fn_autodiff():
    rtc.register("test_rtc_gelu2",
                 lambda x: F.gelu(x, approximate="tanh") * 2)
    try:
        v = np.linspace(-2, 2, 8, dtype=np.float32)
        x = _arr(v)
        x.attach_grad()
        with autograd.record():
            y = nd.test_rtc_gelu2(x)
        y.backward()
        g = jax.grad(lambda u: (jax.nn.gelu(u) * 2).sum())(jnp.asarray(v))
        np.testing.assert_allclose(x.grad.asnumpy(), np.asarray(g),
                                   rtol=1e-5)
    finally:
        rtc.unregister("test_rtc_gelu2")


def test_register_rejects_shadowing():
    with pytest.raises(ValueError, match="already exists"):
        rtc.register("relu", lambda x: x)


def test_tiled_kernel_with_grid():
    fn = ex.kernel("addone")
    x = torch.zeros((32, 16), dtype=torch.float32)
    np.testing.assert_array_equal(fn(x).numpy(), np.ones((32, 16)))
    # one block per 8-row tile, the columns in 256-wide strips
    assert ex._tiles(x) == (1, 4)
    assert ex._tiles(torch.zeros(8192, 4096)) == (16, 1024)


def test_alias_conflict_leaves_registry_clean():
    with pytest.raises(ValueError, match="conflict"):
        rtc.register("test_rtc_fresh", lambda x: x, aliases=("relu",))
    assert "test_rtc_fresh" not in OPS
    # a corrected retry must succeed
    rtc.register("test_rtc_fresh", lambda x: x)
    rtc.unregister("test_rtc_fresh")


def test_vjp_uses_defaults_when_params_omitted():
    fn = ex.kernel("scale")
    rtc.register(
        "test_rtc_defscale", fn, arg_names=["data"],
        vjp=(lambda x, alpha=2.0: (fn(x, alpha=alpha), None),
             lambda alpha, res, g: (g * alpha,)))
    try:
        x = _arr(np.ones((2, 2)))
        x.attach_grad()
        with autograd.record():
            y = nd.test_rtc_defscale(x)      # alpha omitted -> 2.0
        y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), np.full((2, 2), 2.0))
        np.testing.assert_allclose(y.asnumpy(), np.full((2, 2), 2.0))
    finally:
        rtc.unregister("test_rtc_defscale")


def test_aliases_attach_and_unregister():
    rtc.register("test_rtc_primary", lambda x: x * 2,
                 aliases=("test_rtc_alias", "_test_rtc_internal"))
    try:
        out = nd.test_rtc_alias(_arr(np.ones(3)))
        np.testing.assert_allclose(out.asnumpy(), 2.0)
        assert nd._internal._test_rtc_internal is not None
    finally:
        rtc.unregister("test_rtc_primary")
    assert "test_rtc_primary" not in OPS
    assert "test_rtc_alias" not in OPS
    assert not hasattr(nd, "test_rtc_alias")
    assert not hasattr(nd._internal, "_test_rtc_internal")
    # full re-registration under both names succeeds
    rtc.register("test_rtc_primary", lambda x: x,
                 aliases=("test_rtc_alias",))
    rtc.unregister("test_rtc_primary")


def test_register_warns_when_arg_names_uninferrable():
    def star_only(*arrays):
        return arrays[0] + arrays[1]

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        rtc.register("test_rtc_star", star_only)
    try:
        assert any("arg_names" in str(w.message) for w in rec), \
            [str(w.message) for w in rec]
    finally:
        rtc.unregister("test_rtc_star")

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        rtc.register("test_rtc_star2", star_only, arg_names=["a", "b"])
    try:
        assert not any("arg_names" in str(w.message) for w in rec)
        out = nd.test_rtc_star2(_arr([1.0]), _arr([2.0]))
        np.testing.assert_allclose(out.asnumpy(), [3.0])
    finally:
        rtc.unregister("test_rtc_star2")


def test_register_passes_mode_rng_and_aux_state():
    # OpDef's needs_mode / needs_rng / num_aux, as the JAX registry has
    # them: nd fills in _training and _rng, and writes the trailing
    # outputs back into the aux inputs in training mode
    seen = {}

    def fn(data, aux, _training=False, _rng=None):
        seen.update(training=_training, rng=_rng)
        return (data * 2, aux + 1) if _training else data * 2

    rtc.register("test_rtc_aux", fn, needs_mode=True, needs_rng=True,
                 num_aux=1)
    try:
        x, aux = _arr([1.0, 2.0]), _arr([0.0])
        y = nd.test_rtc_aux(x, aux)
        assert seen["training"] is False
        assert isinstance(seen["rng"], torch.Generator)
        np.testing.assert_allclose(y.asnumpy(), [2.0, 4.0])
        np.testing.assert_allclose(aux.asnumpy(), [0.0])
        with autograd.train_mode():
            y = nd.test_rtc_aux(x, aux)
        assert seen["training"] is True
        np.testing.assert_allclose(y.asnumpy(), [2.0, 4.0])
        np.testing.assert_allclose(aux.asnumpy(), [1.0])
    finally:
        rtc.unregister("test_rtc_aux")


# ------------------------------------------- the launcher (built on a card)

ACCEPTED = [("float alpha", "float", False, ctypes.c_float),
            ("double d", "double", False, ctypes.c_double),
            ("int k", "int", False, ctypes.c_int),
            ("long long n", "long long", False, ctypes.c_longlong),
            ("int64_t m", "int64_t", False, ctypes.c_longlong),
            ("const float* x", "float", True, ctypes.c_void_p),
            ("float *__restrict__ o", "float", True, ctypes.c_void_p),
            ("const double* dx", "double", True, ctypes.c_void_p),
            ("int* ix", "int", True, ctypes.c_void_p),
            ("const long long* lx", "long long", True, ctypes.c_void_p),
            ("int64_t* jx", "int64_t", True, ctypes.c_void_p),
            ("const __nv_bfloat16* bx", "__nv_bfloat16", True,
             ctypes.c_void_p),
            ("__half* hx", "__half", True, ctypes.c_void_p),
            ("half* hy", "half", True, ctypes.c_void_p),
            ("void* vx", "void", True, ctypes.c_void_p)]


def test_signature_parse_launcher_text_and_argtypes():
    sig = ", ".join(text for text, *_ in ACCEPTED)
    params = rtc.parse_signature(sig)
    names = [text.split()[-1].lstrip("*") for text, *_ in ACCEPTED]
    assert [p.name for p in params] == names
    assert [(p.base, p.pointer) for p in params] == \
        [(b, ptr) for _, b, ptr, _ in ACCEPTED]
    argtypes = rtc.launcher_argtypes(params)
    assert argtypes[:8] == [ctypes.c_int] * 7 + [ctypes.c_void_p]
    assert argtypes[8:] == [c for *_, c in ACCEPTED]
    text = rtc.launcher_source("k", params)
    assert 'extern "C" int k_launch(int gx, int gy, int gz, int bx' in text
    assert sig in " ".join(text.split())
    assert "k<<<dim3(gx, gy, gz), dim3(bx, by, bz), shared_mem," in text
    assert f">>>({', '.join(names)});" in text
    assert "return (int)cudaGetLastError();" in text
    assert 'extern "C" const char* k_error_name(int e)' in text
    # the four kernels' own signatures, and what their callables hold
    for name in ex.NAMES:
        k = ex.kernel(name)
        assert k.argtypes == rtc.launcher_argtypes(k.params)
        assert f"__global__ void {name}(" in k.source
        assert f"{name}_launch" in k.source
    assert ex.kernel("scale").argtypes[8:] == [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_longlong]


@pytest.mark.parametrize("bad", ["size_t n", "unsigned int k", "float2 v",
                                 "float** pp", "char* s", "float",
                                 "int 3x", "int a, float a"])
def test_signature_parse_refuses(bad):
    with pytest.raises(TypeError):
        rtc.parse_signature(bad)
    if bad == "size_t n":
        with pytest.raises(TypeError, match="size_t"):
            rtc.compile_kernel("", "k", bad, None, grid=(1,))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: reaches the launch path
    of a wrapper on a host with no card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(shape):
    return torch.zeros(shape).as_subclass(_OnCard)


def test_cuda_call_without_card_raises_and_never_runs_the_plain_version(
        monkeypatch, tmp_path):
    def no_nvcc():
        raise RuntimeError("nvcc not found (test)")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    # an empty build directory outside the source tree: nothing is built
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "RTC_DIR", tmp_path / "rtc")
    calls = []
    for name in ex.NAMES:
        k = ex.kernel(name)
        spy = rtc.compile_kernel(
            "", name, ", ".join(p.text for p in k.params), k.out_shape,
            grid=k.grid, scalars=k.scalars,
            reference=lambda *a, **p: calls.append(a))
        spy.source = k.source
        params = {} if name == "addone" else (
            {"alpha": 2.0} if name == "scale"
            else {"alpha": 2.0, "beta": 0.5})
        with pytest.raises(RuntimeError, match="nvcc not found"):
            spy(_on_card((16, 8)), **params)
    # flash_attention allocates its outputs on the card first: torch
    # built without CUDA refuses that, a card without nvcc the build
    monkeypatch.setattr(tflash, "_reference_fwd",
                        lambda *a, **p: calls.append(a))
    q = _on_card((2, 64, 64))
    with pytest.raises((RuntimeError, AssertionError),
                       match="nvcc not found|not compiled with CUDA"):
        tflash.flash_attention_fwd(q, q, q)
    assert not calls
    # and a kernel with no plain version refuses CPU tensors
    bare = rtc.compile_kernel("", "bare", "const float* x, float* o",
                              ex._like, grid=(1,))
    with pytest.raises(mt.MXNetError, match="no plain version"):
        bare(torch.zeros(3))
    # a kernel has no gradient of its own
    with pytest.raises(RuntimeError, match="vjp="):
        ex.kernel("scale")(torch.zeros(3, requires_grad=True), alpha=1.0)


def test_package_kernels_exclude_the_user_kernel_sources():
    # sources() globs csrc/*.cu without recursion: csrc/rtc/*.cu are
    # built through rtc.compile_kernel, not as the package's kernels
    assert set(_build.sources()) == {"flash_fwd", "flash_bwd"}
    assert sorted(p.stem for p in ex.SOURCES.glob("*.cu")) == \
        sorted(ex.NAMES)
    # a source's library is named by the hash of its text
    a = _build._source_target("x", "k")
    assert a.parent == _build.RTC_DIR and a.name.startswith("libk-")
    assert a != _build._source_target("y", "k")


def test_package_library_hashes_the_headers_its_sources_include(
        monkeypatch, tmp_path):
    # a library is named by its source and every csrc/*.cuh, so an edited
    # header rebuilds its users; a header is never a kernel of its own
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "k.cu"
    src.write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// v1\n")
    assert _build.sources() == {"k": src}
    first = _build._target(src)
    assert first.parent == tmp_path / "_build"
    assert first.name.startswith("libk-") and first.suffix == ".so"
    assert _build._target(src) == first
    header.write_text("// v2\n")
    second = _build._target(src)
    assert second != first
    src.write_text('#include "shared.cuh"\n// edited\n')
    assert _build._target(src) not in (first, second)
    assert not (tmp_path / "_build").exists()


# --------------------------------------- the four kernels against JAX's

def _ulp_tol(x, alpha, beta):
    terms = np.abs(x * np.float32(alpha)) + np.float32(abs(beta))
    return 2 * np.spacing(terms.astype(np.float32))


def _pallas(kernel, x, **params):
    fn = mx.rtc.compile_kernel(
        kernel, out_shape=lambda a, **p: jax.ShapeDtypeStruct(a.shape,
                                                              a.dtype),
        interpret=True)
    return np.asarray(fn(jnp.asarray(x), **params))


def test_examples_match_jax_kernels_in_interpret_mode():
    from jax.experimental import pallas as pl
    rs = np.random.RandomState(5)

    def scale_kernel(x_ref, o_ref, *, alpha):
        o_ref[...] = x_ref[...] * alpha

    def fused_scale_shift_relu_kernel(x_ref, o_ref, *, alpha, beta):
        o_ref[...] = jnp.maximum(x_ref[...] * alpha + beta, 0.0)

    def scale_shift_kernel(x_ref, o_ref, *, alpha, beta):
        o_ref[...] = x_ref[...] * alpha + beta

    def addone_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(
        ex.kernel("scale")(torch.from_numpy(x), alpha=3.0).numpy(),
        _pallas(scale_kernel, x, alpha=3.0))
    x = rs.normal(0, 1, (32, 16)).astype(np.float32)
    addone = mx.rtc.compile_kernel(
        addone_kernel, interpret=True,
        out_shape=lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        grid=lambda a: (a.shape[0] // 8,),
        in_specs=lambda a: [pl.BlockSpec((8, a.shape[1]),
                                         lambda i: (i, 0))],
        out_specs=lambda a: pl.BlockSpec((8, a.shape[1]),
                                         lambda i: (i, 0)))
    np.testing.assert_array_equal(
        ex.kernel("addone")(torch.from_numpy(x)).numpy(),
        np.asarray(addone(jnp.asarray(x))))
    for name, kernel, shape, (alpha, beta) in (
            ("fused_scale_shift_relu", fused_scale_shift_relu_kernel,
             (3, 4), (2.0, 0.5)),
            ("scale_shift", scale_shift_kernel, (256, 256), (2.0, -1.0)),
            ("scale_shift", scale_shift_kernel, (256, 256), (1.7, 0.3))):
        x = rs.normal(0, 1, shape).astype(np.float32)
        got = ex.kernel(name)(torch.from_numpy(x), alpha=alpha,
                              beta=beta).numpy()
        want = _pallas(kernel, x, alpha=alpha, beta=beta)
        assert (np.abs(got - want) <= _ulp_tol(x, alpha, beta)).all(), name
    # the VJPs: scale's g * alpha, the example's g * (y > 0) * alpha
    g = rs.normal(0, 1, (3, 4)).astype(np.float32)
    fwd, bwd = ex.scale_vjp()
    (dx,) = bwd(3.0, fwd(torch.from_numpy(g), alpha=3.0)[1],
                torch.from_numpy(g))
    np.testing.assert_array_equal(dx.numpy(), g * np.float32(3.0))
    x = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    fwd, bwd = ex.fused_scale_shift_relu_vjp()
    y, res = fwd(torch.from_numpy(x), alpha=2.0, beta=0.5)
    (dx,) = bwd(2.0, 0.5, res, torch.from_numpy(g))
    want = np.asarray(g * (np.maximum(x * 2.0 + 0.5, 0.0) > 0) * 2.0)
    np.testing.assert_array_equal(dx.numpy(), want)


# ------------------------------- chip_smoke.py's rtc path, at a small size

def _jax_loop(x, w, t, steps, lr):
    def kernel(x_ref, o_ref, *, alpha, beta):
        o_ref[...] = jnp.maximum(x_ref[...] * alpha + beta, 0.0)

    fused = mx.rtc.compile_kernel(
        kernel, out_shape=lambda a, alpha=1.0, beta=0.0:
        jax.ShapeDtypeStruct(a.shape, a.dtype))

    def fwd(a, alpha=1.0, beta=0.0):
        y = fused(a, alpha=alpha, beta=beta)
        return y, (y,)

    def bwd(alpha, beta, res, g):
        (y,) = res
        return (g * (y > 0) * alpha,)

    mx.rtc.register("test_torch_rtc_ssr", fused, arg_names=["data"],
                    vjp=(fwd, bwd))
    try:
        xn, wn, tn = (mx.nd.array(a) for a in (x, w, t))
        wn.attach_grad()
        losses = []
        for _ in range(steps):
            with mx.autograd.record():
                h = mx.nd.test_torch_rtc_ssr(mx.nd.dot(xn, wn), alpha=2.0,
                                             beta=0.5)
                loss = mx.nd.mean(mx.nd.square(h - tn))
            loss.backward()
            mx.nd.sgd_update(wn, wn.grad, lr=lr, out=wn)
            losses.append(float(loss.asnumpy()))
        return losses, wn.asnumpy(), wn.grad.asnumpy()
    finally:
        mx.rtc.unregister("test_torch_rtc_ssr")


def test_rtc_path_matches_jax_loop():
    rs = np.random.RandomState(0)
    x = rs.normal(0, 1, (16, 8)).astype(np.float32)
    w = (rs.normal(0, 1, (8, 32)) / np.sqrt(8)).astype(np.float32)
    t = rs.normal(0, 1, (16, 32)).astype(np.float32)
    steps, lr = 5, 2.0
    ex.register_scale_shift_relu("test_torch_rtc_ssr")
    try:
        xn, wn, tn = (nd.array(a, ctx=CPU) for a in (x, w, t))
        wn.attach_grad()
        losses = [float(ex.train_step(xn, wn, tn, lr,
                                      op="test_torch_rtc_ssr").asnumpy())
                  for _ in range(steps)]
    finally:
        rtc.unregister("test_torch_rtc_ssr")
    jl, jw, jg = _jax_loop(x, w, t, steps, lr)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    np.testing.assert_allclose(wn.asnumpy(), jw, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wn.grad.asnumpy(), jg, rtol=1e-5, atol=1e-7)
    assert losses[-1] < losses[0]
