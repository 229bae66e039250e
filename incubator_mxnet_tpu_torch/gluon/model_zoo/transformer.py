"""Decoder-only transformer LM (twin of
``incubator_mxnet_tpu/gluon/model_zoo/transformer.py``): inference and
training.

``TransformerLM.forward`` scores a batch of token sequences and is
differentiable: under ``.train()`` its dropout is active, and a train
step (``parallel.ShardedTrainStep``) takes its gradient.  ``generate``
runs one batched prefill and then decodes token by token against a
preallocated KV cache, as the JAX package's ``_build_decode`` does.
Every layer's attention in ``forward`` and in the prefill goes through
``ops.flash.flash_attention``: on a CUDA card that is the hand-written
kernel ``csrc/flash_fwd.cu``, and its gradient the kernels
``flash_dq`` and ``flash_dkv`` of ``csrc/flash_bwd.cu``.  The one-token
decode step attends to the cache with plain matrix products, as the JAX
package does outside any kernel.

Not in this slice (each raises ``NotImplementedError``): MoE FFNs,
sequence parallelism, int8 weights and the paged serving builders.
"""
import math

import numpy as np
import torch
from torch import nn

from ... import context
from ...ops.flash import flash_attention
from ...ops.matrix import rope_fn
from ..nn import Dense, Dropout, Embedding, LayerNorm

__all__ = ["TransformerLM", "TransformerBlock", "CausalSelfAttention",
           "transformer_lm"]


def _not_ported(what, where):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; it comes with "
        f"the {where} slice")


def _jln(x, gb):
    """LayerNorm over the last axis (eps 1e-5), from a (gamma, beta)
    pair: the decode path's formula."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * gb[0] + gb[1]


def _ffn_rows(lw, x2d):
    """Dense FFN on flattened (T, D) tokens."""
    return torch.relu(x2d @ lw["up"][0].T + lw["up"][1]) \
        @ lw["down"][0].T + lw["down"][1]


def _heads(t, b, l, h, dh):
    """(B, L, H*dh) or (B, L, H, dh) -> contiguous (B*H, L, dh)."""
    return t.reshape(b, l, h, dh).transpose(1, 2) \
        .reshape(b * h, l, dh).contiguous()


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention with grouped-query heads
    (``n_kv_heads``), optional RoPE and a sliding window
    (``attn_window``): query i sees keys (i - window, i]."""

    def __init__(self, d_model, n_heads, seq_parallel=False, rope=False,
                 n_kv_heads=None, attn_window=0, *, device=None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model ({d_model}) must be a multiple "
                             f"of n_heads ({n_heads})")
        if seq_parallel:
            raise _not_ported("seq_parallel (ring/Ulysses attention)",
                              "parallel-modes")
        if attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {attn_window}")
        kv = n_kv_heads if n_kv_heads is not None else n_heads
        if kv <= 0 or n_heads % kv:
            raise ValueError(
                f"n_heads ({n_heads}) must be a positive multiple of "
                f"n_kv_heads ({kv})")
        self._window = int(attn_window)
        self._rope = bool(rope)
        self._d = d_model
        self._h = n_heads
        self._kv = kv
        self._dh = d_model // n_heads
        self.qkv = Dense(d_model + 2 * kv * self._dh, flatten=False,
                         in_units=d_model, device=device)
        self.proj = Dense(d_model, flatten=False, in_units=d_model,
                          device=device)

    def forward(self, x, kv_out=None):
        """Attention over x (B, L, d).  A list ``kv_out`` receives this
        layer's K and V as (B, L, kv, dh), after RoPE: what a KV cache
        holds."""
        b, l, d = x.shape
        h, dh, kv = self._h, self._dh, self._kv
        kvd = kv * dh
        q, k, v = self.qkv(x).split([d, kvd, kvd], dim=2)
        q = q.reshape(b, l, h, dh)
        k = k.reshape(b, l, kv, dh)
        v = v.reshape(b, l, kv, dh)
        if self._rope:
            q, k = rope_fn(q), rope_fn(k)
        if kv_out is not None:
            kv_out.append((k, v))
        if kv != h:
            # each kv group serves h/kv query heads (autograd sums the
            # groups' dk/dv over the repeated heads)
            k = k.repeat_interleave(h // kv, dim=2)
            v = v.repeat_interleave(h // kv, dim=2)
        out = flash_attention(_heads(q, b, l, h, dh),
                              _heads(k, b, l, h, dh),
                              _heads(v, b, l, h, dh),
                              causal=True, window=self._window)
        out = out.reshape(b, h, l, dh).transpose(1, 2).reshape(b, l, d)
        return self.proj(out)


class TransformerBlock(nn.Module):
    """Pre-norm attention + MLP with residuals (GPT-2 layout).
    ``moe_capacity_factor`` is the reference's MoE FFN capacity; the
    MoE FFN itself (``moe_experts > 0``) is not ported yet."""

    def __init__(self, d_model, n_heads, mlp_ratio=4, dropout=0.0,
                 seq_parallel=False, moe_experts=0,
                 moe_capacity_factor=1.25, rope=False, n_kv_heads=None,
                 attn_window=0, *, device=None):
        super().__init__()
        if moe_experts > 0:
            raise _not_ported("moe_experts > 0 (ops/moe.py)", "MoE")
        self.ln1 = LayerNorm(in_channels=d_model, device=device)
        self.attn = CausalSelfAttention(
            d_model, n_heads, seq_parallel=seq_parallel, rope=rope,
            n_kv_heads=n_kv_heads, attn_window=attn_window, device=device)
        self.ln2 = LayerNorm(in_channels=d_model, device=device)
        self.up = Dense(mlp_ratio * d_model, flatten=False,
                        activation="relu", in_units=d_model, device=device)
        self.down = Dense(d_model, flatten=False,
                          in_units=mlp_ratio * d_model, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x, kv_out=None):
        x = x + self.drop(self.attn(self.ln1(x), kv_out))
        return x + self.drop(self.down(self.up(self.ln2(x))))


class TransformerLM(nn.Module):
    """Token-in, logits-out decoder LM.

    Parameters as the JAX package's, in its order: vocab_size,
    d_model, n_layers, n_heads, max_len (learned positions), mlp_ratio,
    dropout, seq_parallel, moe_experts, moe_capacity_factor, pos
    ('learned' or 'rope'), n_kv_heads, attn_window; plus the
    keyword-only ``device`` (None: the first CUDA card, raising if
    there is none).  Parameters
    are float32 and uninitialized until ``initializer.initialize`` or
    ``convert.load_reference_weights``.
    """

    def __init__(self, vocab_size, d_model=512, n_layers=6, n_heads=8,
                 max_len=1024, mlp_ratio=4, dropout=0.0,
                 seq_parallel=False, moe_experts=0,
                 moe_capacity_factor=1.25, pos="learned", n_kv_heads=None,
                 attn_window=0, *, device=None):
        super().__init__()
        if pos not in ("learned", "rope"):
            raise ValueError(
                f"pos must be 'learned' or 'rope', got {pos!r}")
        kw = dict(device=context.resolve(device))
        self._d = d_model
        self._max_len = max_len
        self._mlp_ratio = mlp_ratio
        self._pos_kind = pos
        self.embed = Embedding(vocab_size, d_model, **kw)
        if pos == "learned":
            self.pos = Embedding(max_len, d_model, **kw)
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, n_heads, mlp_ratio, dropout,
                             seq_parallel=seq_parallel,
                             moe_experts=moe_experts,
                             moe_capacity_factor=moe_capacity_factor,
                             rope=(pos == "rope"), n_kv_heads=n_kv_heads,
                             attn_window=attn_window, **kw)
            for _ in range(n_layers))
        self.ln_f = LayerNorm(in_channels=d_model, **kw)
        self.head = Dense(vocab_size, flatten=False, use_bias=False,
                          in_units=d_model, **kw)
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.attn_window = int(attn_window)

    @property
    def device(self):
        return self.embed.weight.device

    def _tokens(self, tokens):
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)

    def forward(self, tokens):
        """Logits (B, L, V) for int tokens (B, L)."""
        return self.head(self.ln_f(self._hidden(self._tokens(tokens))))

    def _hidden(self, tokens, kv_out=None):
        """The last block's output (B, L, d); ``kv_out`` collects each
        layer's K/V (see ``CausalSelfAttention.forward``)."""
        l = tokens.shape[1]
        if l > self._max_len:
            raise ValueError(
                f"sequence {l} exceeds max_len {self._max_len}")
        x = self.embed(tokens) * math.sqrt(self._d)
        if self._pos_kind == "learned":
            x = x + self.pos(torch.arange(l, device=x.device))[None]
        for blk in self.blocks:
            x = blk(x, kv_out)
        return x

    def train_flops_per_token(self, seq_len):
        """Matmul FLOPs per token of one forward + backward step (the
        3x-forward rule), for MFU; the JAX model's count."""
        d = self._d
        mlp = 2 * 2 * d * self._mlp_ratio * d       # dense up + down
        kvd = self.n_kv_heads * (d // self.n_heads)
        att_span = min(seq_len, self.attn_window) \
            if self.attn_window else seq_len
        per_layer = (2 * d * (d + 2 * kvd)          # qkv (GQA-sized)
                     + 2 * d * d                    # proj
                     + 2 * 2 * att_span * d         # scores + att @ v
                     + mlp)
        vocab = self.head.weight.shape[0]
        return 3 * (self.n_layers * per_layer + 2 * d * vocab)

    # ------------------------------------------------------------ decode
    def _decode_params(self):
        """The parameters in the JAX package's ``_decode_weights()``
        layout: embed, pos, layers[i].{ln1,qkv,proj,ln2,up,down},
        ln_f, head."""
        def pair(m, a="weight", b="bias"):
            return (getattr(m, a), getattr(m, b))

        layers = [dict(ln1=pair(blk.ln1, "gamma", "beta"),
                       qkv=pair(blk.attn.qkv), proj=pair(blk.attn.proj),
                       ln2=pair(blk.ln2, "gamma", "beta"),
                       up=pair(blk.up), down=pair(blk.down))
                  for blk in self.blocks]
        wts = dict(embed=self.embed.weight,
                   ln_f=pair(self.ln_f, "gamma", "beta"),
                   head=self.head.weight, layers=layers)
        if self._pos_kind == "learned":
            wts["pos"] = self.pos.weight
        return wts

    @torch.inference_mode()
    def generate(self, tokens, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, generator=None):
        """Autoregressive decode with a KV cache: one batched prefill
        over the prompt (through the flash kernel), then one step per
        new token.

        tokens : (B, P) int prompt (tensor or array-like)
        temperature : 0 -> greedy argmax, > 0 -> categorical sample
        top_k : keep only the k most probable tokens (0 = all)
        top_p : nucleus sampling, keep the smallest set of tokens whose
            cumulative probability exceeds top_p (1.0 = all)
        generator : torch.Generator on the model's device for sampling
            (None: a fresh one seeded with 0, as the JAX package's
            default key is PRNGKey(0))
        returns (B, P + max_new_tokens) int32 tensor
        """
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (got {top_k})")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (got {top_p})")
        max_new = int(max_new_tokens)
        if max_new < 0:
            raise ValueError(
                f"max_new_tokens must be >= 0 (got {max_new})")
        prompt = self._tokens(tokens)
        b, p = prompt.shape
        total = p + max_new
        if total > self._max_len:
            raise ValueError(
                f"prompt+new = {total} exceeds max_len {self._max_len}")
        if max_new == 0:
            return prompt.to(torch.int32)
        sample = temperature > 0
        if sample and generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)

        def pick(logits):
            if not sample:
                return logits.argmax(-1)
            probs = torch.softmax(
                _restrict(logits / temperature, int(top_k), float(top_p)),
                dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]

        wts = self._decode_params()     # no autograd: inference mode
        was_training = self.training
        self.eval()                     # no dropout in the prefill
        try:
            caches, logits = self._prefill(prompt, total)
        finally:
            self.train(was_training)
        toks = torch.zeros((b, total), dtype=torch.int64,
                           device=self.device)
        toks[:, :p] = prompt
        toks[:, p] = pick(logits)
        # positions p .. total-2 each consume the token at i and emit
        # the one at i+1 (the prefill already emitted p)
        for i in range(p, total - 1):
            toks[:, i + 1] = pick(self._step(wts, caches, toks[:, i], i))
        return toks.to(torch.int32)

    def _prefill(self, prompt, total):
        """``forward`` over the prompt (through the flash kernel), which
        also fills the first P positions of a (B, kv, total, dh) K/V
        cache per layer; returns the caches and the last position's
        logits."""
        b, p = prompt.shape
        kvs = []
        x = self._hidden(prompt, kvs)
        caches = []
        for k, v in kvs:
            kc = k.new_zeros((b, k.shape[2], total, k.shape[3]))
            vc = torch.zeros_like(kc)
            kc[:, :, :p] = k.transpose(1, 2)
            vc[:, :, :p] = v.transpose(1, 2)
            caches.append((kc, vc))
        return caches, self.head(self.ln_f(x[:, -1]))

    def _step(self, wts, caches, tok, i):
        """One token per batch row at absolute position i: writes its
        K/V into the caches in place and returns (B, V) logits."""
        d, h, kv = self._d, self.n_heads, self.n_kv_heads
        dh = d // h
        kvd = kv * dh
        b = tok.shape[0]
        window = self.attn_window
        lo = max(0, i - window + 1) if window else 0
        x = wts["embed"][tok] * math.sqrt(d)
        if self._pos_kind == "learned":
            x = x + wts["pos"][i]
        for lw, (kc, vc) in zip(wts["layers"], caches):
            xa = _jln(x, lw["ln1"])
            qkv = xa @ lw["qkv"][0].T + lw["qkv"][1]
            q = qkv[:, :d].reshape(b, 1, h, dh)
            k = qkv[:, d:d + kvd].reshape(b, 1, kv, dh)
            if self._pos_kind == "rope":
                q, k = rope_fn(q, offset=i), rope_fn(k, offset=i)
            kc[:, :, i] = k[:, 0]
            vc[:, :, i] = qkv[:, d + kvd:].reshape(b, kv, dh)
            # the keys the mask keeps: positions lo .. i
            qg = q.reshape(b, kv, h // kv, dh)
            s = torch.einsum("bkrd,bkcd->bkrc", qg, kc[:, :, lo:i + 1]) \
                / math.sqrt(dh)
            att = torch.softmax(s, dim=-1)
            o = torch.einsum("bkrc,bkcd->bkrd", att, vc[:, :, lo:i + 1])
            x = x + o.reshape(b, d) @ lw["proj"][0].T + lw["proj"][1]
            x = x + _ffn_rows(lw, _jln(x, lw["ln2"]))
        return _jln(x, wts["ln_f"]) @ wts["head"].T


def _restrict(logits, top_k, top_p):
    """top-k / nucleus filtering on (B, V) logits."""
    if top_k and top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # number of tokens needed to reach top_p (>= 1)
        k_eff = torch.clamp((cum - probs < top_p).sum(-1, keepdim=True),
                            min=1)
        cutoff = torch.gather(sorted_l, -1, k_eff - 1)
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    return logits


def transformer_lm(vocab_size=32000, size="small", **kwargs):
    """Factory: 'small' (125M-class), 'medium' (350M-class), 'modern'
    (RoPE + grouped-query), or explicit dims via kwargs.  ``device``
    defaults to the first CUDA card."""
    presets = {
        "small": dict(d_model=768, n_layers=12, n_heads=12),
        "medium": dict(d_model=1024, n_layers=24, n_heads=16),
        "modern": dict(d_model=768, n_layers=12, n_heads=12,
                       n_kv_heads=4, pos="rope"),
    }
    if size not in presets:
        raise ValueError(
            f"unknown size {size!r}; presets: {sorted(presets)} "
            "(pass explicit dims via kwargs with any preset)")
    cfg = dict(presets[size])
    cfg.update(kwargs)
    return TransformerLM(vocab_size, **cfg)
