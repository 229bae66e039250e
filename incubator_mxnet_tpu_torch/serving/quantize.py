"""int8 weight quantization for serving density (twin of
``incubator_mxnet_tpu/serving/quantize.py``).

Decode at small batch streams every weight once per step, so its pace
is set by the weight bytes: int8 storage with per-output-channel fp32
scales cuts them about 4x against fp32 (symmetric absmax quantization,
the standard W8 recipe).

The representation keeps the weight dict's SHAPE: every 2-D float
matrix of a ``TransformerLM._decode_params()`` dict (qkv / proj / up /
down projections, the head, and the embedding tables) becomes
``{"q": int8 (out, in), "s": float32 (out,)}``; biases and LayerNorm
affines stay fp32.  The paged builders
(``gluon/model_zoo/transformer.py``) detect the dict leaves and
dequantize at use: matrices as ``q.float() * s[:, None]``, embedding
tables per gathered row only.
"""
import torch

__all__ = ["quantize_weights", "quantization_error", "weights_nbytes"]


def _q2d(w):
    """Symmetric absmax int8 per output channel (axis 0)."""
    w = w.detach()
    amax = w.abs().amax(dim=1)
    s = torch.where(amax > 0, amax / 127.0,
                    torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127) \
        .to(torch.int8)
    return {"q": q, "s": s}


def quantize_weights(wts, include_embeddings=True):
    """Quantize a ``TransformerLM._decode_params()`` dict to int8.

    Returns a NEW dict (the input is untouched) with every dense 2-D
    projection replaced by ``{"q", "s"}`` pairs.  With
    ``include_embeddings=False`` the token/position tables stay fp32."""
    out = {"ln_f": wts["ln_f"], "layers": []}
    if include_embeddings:
        out["embed"] = _q2d(wts["embed"])
        if "pos" in wts:
            out["pos"] = _q2d(wts["pos"])
    else:
        out["embed"] = wts["embed"]
        if "pos" in wts:
            out["pos"] = wts["pos"]
    out["head"] = _q2d(wts["head"])
    for lw in wts["layers"]:
        nl = dict(ln1=lw["ln1"], ln2=lw["ln2"],
                  qkv=(_q2d(lw["qkv"][0]), lw["qkv"][1]),
                  proj=(_q2d(lw["proj"][0]), lw["proj"][1]))
        if "moe" in lw:
            # stacked (E, H, D) expert weights stay fp32, as in the JAX
            # package: per-expert scales would need a 3-D scale plan
            nl["moe"] = lw["moe"]
        else:
            nl["up"] = (_q2d(lw["up"][0]), lw["up"][1])
            nl["down"] = (_q2d(lw["down"][0]), lw["down"][1])
        out["layers"].append(nl)
    return out


def quantization_error(wts, qwts):
    """Max relative reconstruction error over quantized matrices — a
    cheap sanity probe (the real acceptance is logit-level)."""
    errs = []

    def walk(a, b):
        if isinstance(b, dict) and set(b) == {"q", "s"}:
            deq = b["q"].float() * b["s"][:, None]
            a = a.detach()
            denom = max(a.abs().max().item(), 1e-12)
            errs.append((deq - a).abs().max().item() / denom)
        elif isinstance(b, dict):
            for k in b:
                walk(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            for x, y in zip(a, b):
                walk(x, y)

    walk(wts, qwts)
    return max(errs) if errs else 0.0


def weights_nbytes(wts):
    """Total bytes of every tensor leaf (int8 payloads and scales
    included): the density number."""
    if isinstance(wts, torch.Tensor):
        return wts.numel() * wts.element_size()
    if isinstance(wts, dict):
        return sum(weights_nbytes(v) for v in wts.values())
    if isinstance(wts, (list, tuple)):
        return sum(weights_nbytes(v) for v in wts)
    return 0
