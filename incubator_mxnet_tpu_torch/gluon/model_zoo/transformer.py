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

The paged builders (``_build_paged_prefill``, ``_build_paged_step``)
are the serving engine's (``serving/engine.py``): the same decode math
over KV pools indexed by block tables, with no kernel of their own, as
in the JAX package.  They read int8 ``{q, s}`` weights
(``serving/quantize.py``) and dequantize at use.

``moe_experts > 0`` swaps each block's dense FFN for a top-2-routed
Mixture-of-Experts FFN (``MoEFFN``, over ``ops.moe``); ``forward`` then
returns ``[logits, aux]``, aux the summed router load-balance loss, and
``generate``'s decode routes through the same code with the tokens of
one step (the batch) as T.  Paged serving of MoE models stays refused,
as in the JAX package.

Not in this slice (raises ``NotImplementedError``): sequence
parallelism.
"""
import math
import time

import numpy as np
import torch
from torch import nn

from ... import context, tracing
from ...ops.flash import flash_attention
from ...ops.matrix import rope_fn
from ...ops.moe import moe_ffn_fn
from ..nn import Dense, Dropout, Embedding, LayerNorm

__all__ = ["TransformerLM", "TransformerBlock", "CausalSelfAttention",
           "MoEFFN", "transformer_lm"]


def _not_ported(what, where):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; it comes with "
        f"the {where} slice")


def _q_mat(w):
    """Dense matrix, dequantized if int8: ``q * s`` per out-channel."""
    if isinstance(w, dict):
        return w["q"].float() * w["s"][:, None]
    return w


def _q_rows(w, idx):
    """Embedding-table gather; quantized tables dequantize only the
    gathered rows, never the dense table."""
    if isinstance(w, dict):
        return w["q"][idx].float() * w["s"][idx][..., None]
    return w[idx]


def _jln(x, gb):
    """LayerNorm over the last axis (eps 1e-5), from a (gamma, beta)
    pair: the decode path's formula."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * gb[0] + gb[1]


def _ffn_rows(lw, cf, x2d):
    """Dense or MoE FFN on flattened (T, D) tokens (int8 dense weights
    dequantized); ``cf`` is an MoE layer's capacity factor.  The same
    routing code as training."""
    if "moe" in lw:
        return moe_ffn_fn(x2d, *lw["moe"], capacity_factor=cf)[0]
    return torch.relu(x2d @ _q_mat(lw["up"][0]).T + lw["up"][1]) \
        @ _q_mat(lw["down"][0]).T + lw["down"][1]


def _rope_rows(x, pos, base=10000.0):
    """RoPE for one token per batch row: x (B, H, Dh), pos (B,)
    absolute positions.  The per-row form of ``ops.matrix.rope_fn(...,
    offset=i)``, with its angle formula, so paged decode rotates
    exactly as ``generate()``'s step does."""
    half = x.shape[-1] // 2
    dev = x.device
    inv = torch.pow(torch.tensor(float(base), device=dev),
                    -torch.arange(half, dtype=torch.float32,
                                  device=dev) / half)
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


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


class MoEFFN(nn.Module):
    """Mixture-of-Experts FFN (GShard top-2; see ``ops/moe.py``).

    Expert weights are stacked over a leading expert dimension, (E, H,
    D) and (E, D, H), under the reference's names (``router_weight``,
    ``expert_up_weight``, ``expert_up_bias``, ``expert_down_weight``,
    ``expert_down_bias``), so the expert compute is one batched product.
    ``forward`` returns the output and keeps the load-balance aux loss
    as ``self.last_aux`` (read it in the same forward; add ~1e-2 of it
    to the loss).  Parameters are float32 and uninitialized until
    ``initializer.initialize`` (biases: zeros) or
    ``convert.load_reference_weights``."""

    def __init__(self, d_model, num_experts, hidden, capacity_factor=1.25,
                 *, device=None):
        super().__init__()
        self._cf = float(capacity_factor)
        self.num_experts = num_experts

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.router_weight = param(num_experts, d_model)
        self.expert_up_weight = param(num_experts, hidden, d_model)
        self.expert_up_bias = param(num_experts, hidden)
        self.expert_down_weight = param(num_experts, d_model, hidden)
        self.expert_down_bias = param(num_experts, d_model)
        self.last_aux = None

    def weights(self):
        """The five tensors in ``moe_ffn_fn``'s order."""
        return (self.router_weight, self.expert_up_weight,
                self.expert_up_bias, self.expert_down_weight,
                self.expert_down_bias)

    def forward(self, x):                      # (B, L, D)
        b, l, d = x.shape
        y, aux = moe_ffn_fn(x.reshape(b * l, d), *self.weights(),
                            capacity_factor=self._cf)
        self.last_aux = aux
        return y.reshape(b, l, d)


class TransformerBlock(nn.Module):
    """Pre-norm attention + MLP with residuals (GPT-2 layout).

    ``moe_experts > 0`` swaps the dense MLP for a top-2-routed
    Mixture-of-Experts FFN (``MoEFFN``); the block then keeps the
    router's load-balance loss as ``self.last_aux``."""

    def __init__(self, d_model, n_heads, mlp_ratio=4, dropout=0.0,
                 seq_parallel=False, moe_experts=0,
                 moe_capacity_factor=1.25, rope=False, n_kv_heads=None,
                 attn_window=0, *, device=None):
        super().__init__()
        self.moe_experts = int(moe_experts)
        self.ln1 = LayerNorm(in_channels=d_model, device=device)
        self.attn = CausalSelfAttention(
            d_model, n_heads, seq_parallel=seq_parallel, rope=rope,
            n_kv_heads=n_kv_heads, attn_window=attn_window, device=device)
        self.ln2 = LayerNorm(in_channels=d_model, device=device)
        if moe_experts:
            self.moe = MoEFFN(d_model, moe_experts, mlp_ratio * d_model,
                              capacity_factor=moe_capacity_factor,
                              device=device)
        else:
            self.up = Dense(mlp_ratio * d_model, flatten=False,
                            activation="relu", in_units=d_model,
                            device=device)
            self.down = Dense(d_model, flatten=False,
                              in_units=mlp_ratio * d_model, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x, kv_out=None):
        x = x + self.drop(self.attn(self.ln1(x), kv_out))
        if self.moe_experts:
            y = self.moe(self.ln2(x))
            self.last_aux = self.moe.last_aux
            return x + self.drop(y)
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
        self._generate_signatures = set()   # compile-ledger attribution
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
        self.moe_experts = int(moe_experts)

    @property
    def device(self):
        return self.embed.weight.device

    def _tokens(self, tokens):
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)

    def forward(self, tokens):
        """Logits (B, L, V) for int tokens (B, L); with ``moe_experts``
        the return is ``[logits, aux]``, aux the summed router
        load-balance loss (add ~1e-2 of it to the training loss)."""
        x = self._hidden(self._tokens(tokens))
        logits = self.head(self.ln_f(x))
        if not self.moe_experts:
            return logits
        aux = None
        for blk in self.blocks:
            aux = blk.last_aux if aux is None else aux + blk.last_aux
            # a tensor left on a block would keep this forward's autograd
            # graph alive past the step (and a CUDA graph capture after
            # it would sync with the stream that graph was made on)
            blk.last_aux = blk.moe.last_aux = None
        return [logits, aux]

    def _hidden(self, tokens, kv_out=None):
        """The last block's output (B, L, d); ``kv_out`` collects each
        layer's K/V (see ``CausalSelfAttention.forward``).  MoE blocks
        keep their aux loss as ``last_aux``."""
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

    def _mlp_flops(self):
        """Matmul FLOPs per token of one layer's FFN: top-2 MoE runs two
        experts' up + down and the router."""
        d = self._d
        hid = self._mlp_ratio * d
        if self.moe_experts:
            return 2 * (2 * 2 * d * hid) + 2 * d * self.moe_experts
        return 2 * 2 * d * hid                      # dense up + down

    def train_flops_per_token(self, seq_len):
        """Matmul FLOPs per token of one forward + backward step (the
        3x-forward rule), for MFU; the JAX model's count."""
        d = self._d
        mlp = self._mlp_flops()
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
        layout: embed, pos, layers[i].{ln1,qkv,proj,ln2} and either
        {up,down} or moe (router, up weight and bias, down weight and
        bias), ln_f, head."""
        def pair(m, a="weight", b="bias"):
            return (getattr(m, a), getattr(m, b))

        layers = []
        for blk in self.blocks:
            lw = dict(ln1=pair(blk.ln1, "gamma", "beta"),
                      qkv=pair(blk.attn.qkv), proj=pair(blk.attn.proj),
                      ln2=pair(blk.ln2, "gamma", "beta"))
            if blk.moe_experts:
                lw["moe"] = blk.moe.weights()
            else:
                lw["up"] = pair(blk.up)
                lw["down"] = pair(blk.down)
            layers.append(lw)
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

        key = (b, p, max_new, sample, int(top_k), float(top_p))
        t0 = time.monotonic()
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
        if key not in self._generate_signatures:
            # the first run of a (shape, decode config) signature, where
            # the JAX package compiles: the compile ledger attributes it
            self._generate_signatures.add(key)
            tracing.compile_ledger("transformer_generate").record(
                {"shape": (b, p),
                 "static_arg": (max_new, sample, key[4], key[5])},
                time.monotonic() - t0)
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
        for lw, cf, (kc, vc) in zip(wts["layers"], self._cfs(), caches):
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
            x = x + _ffn_rows(lw, cf, _jln(x, lw["ln2"]))
        return _jln(x, wts["ln_f"]) @ wts["head"].T

    def _cfs(self):
        """Each layer's MoE capacity factor (None for a dense layer)."""
        return [blk.moe._cf if blk.moe_experts else None
                for blk in self.blocks]

    # ---------------------------------------------------- paged decode
    # Block-table variants of prefill and step for the serving engine
    # (serving/engine.py).  KV lives in fixed pools of shape
    # (num_blocks, block_size, kv_heads, head_dim) per layer; a request's
    # context is the ordered block-id row it owns.  Scatter and gather by
    # block id happen inside the function, so admission and retirement
    # never change its shapes: one captured decode graph per engine.
    # Both update the pools IN PLACE (torch has no donation) and return
    # (next_token(s), logits).

    def _check_paged(self):
        if self.attn_window:
            raise NotImplementedError(
                "paged serving over sliding-window attention is not "
                "implemented — serve attn_window=0 models, or decode "
                "via generate()")
        if self.moe_experts:
            # top-2 routing sets expert capacity from the BATCH of
            # tokens in flight: concurrent slots contend for capacity a
            # sequential generate() call never sees, so served logits
            # would depend on batch occupancy
            raise NotImplementedError(
                "paged serving of MoE models is not implemented — "
                "shared expert capacity makes logits depend on "
                "batchmates; decode MoE models via generate()")

    def _paged_dims(self):
        d, h, kv = self._d, self.n_heads, self.n_kv_heads
        return d, h, kv, d // h, h // kv, kv * (d // h)

    def _build_paged_prefill(self, suffix_len, max_blocks, block_size):
        """Suffix prefill over the block-table cache.

        Embeds ``S = suffix_len`` tokens at absolute positions ``n_past
        + i``, scatters their K/V into the request's blocks, and attends
        over the whole block-table context: ``n_past = 0`` is a full
        prefill, ``n_past > 0`` resumes after a prefix-cache hit without
        recomputing the shared blocks.  Rows past ``true_len`` are
        padding: they scatter to the scratch block (id 0), and their
        outputs are discarded.

        Returns ``prefill(wts, kpools, vpools, table, n_past, tokens,
        true_len) -> (next_token, logits)``: ``table`` (max_blocks,) and
        ``tokens`` (S,) are int64 tensors on the model's device,
        ``n_past`` and ``true_len`` ints; ``next_token`` is the greedy
        argmax after the last real suffix token.
        """
        self._check_paged()
        d, h, kv, dh, rep, kvd = self._paged_dims()
        scale = math.sqrt(d)
        use_rope = self._pos_kind == "rope"
        max_len = self._max_len
        S, MB, bs = int(suffix_len), int(max_blocks), int(block_size)
        C = MB * bs

        def prefill(wts, kpools, vpools, table, n_past, tokens, true_len):
            dev = tokens.device
            rows = torch.arange(S, device=dev)
            x = _q_rows(wts["embed"], tokens) * scale          # (S, D)
            pos = n_past + rows
            if not use_rope:
                x = x + _q_rows(wts["pos"], pos.clamp(max=max_len - 1))
            valid = rows < true_len
            wpos = torch.where(valid, pos, 0)
            blk = torch.where(valid, table[(wpos // bs).clamp(max=MB - 1)],
                              0)
            off = wpos % bs
            keep = torch.arange(C, device=dev)[None, :] <= pos[:, None]
            for li, lw in enumerate(wts["layers"]):
                xa = _jln(x, lw["ln1"])
                qkvm = xa @ _q_mat(lw["qkv"][0]).T + lw["qkv"][1]
                q = qkvm[:, :d].reshape(S, h, dh)
                k = qkvm[:, d:d + kvd].reshape(S, kv, dh)
                v = qkvm[:, d + kvd:].reshape(S, kv, dh)
                if use_rope:
                    q = rope_fn(q[None], offset=n_past)[0]
                    k = rope_fn(k[None], offset=n_past)[0]
                kpools[li][blk, off] = k
                vpools[li][blk, off] = v
                # gather the whole context back through the table: lane
                # c of the flattened (C,) axis IS absolute position c,
                # because the row is ordered by logical block index
                kc = kpools[li][table].reshape(C, kv, dh).transpose(0, 1)
                vc = vpools[li][table].reshape(C, kv, dh).transpose(0, 1)
                qg = q.transpose(0, 1).reshape(kv, rep, S, dh)
                s = torch.einsum("krsd,kcd->krsc", qg, kc) / math.sqrt(dh)
                att = torch.softmax(torch.where(keep[None, None], s, -1e9),
                                    dim=-1)
                o = torch.einsum("krsc,kcd->krsd", att, vc)
                o = o.reshape(h, S, dh).transpose(0, 1).reshape(S, d)
                x = x + o @ _q_mat(lw["proj"][0]).T + lw["proj"][1]
                x = x + _ffn_rows(lw, None, _jln(x, lw["ln2"]))
            logits = _jln(x[true_len - 1], wts["ln_f"]) \
                @ _q_mat(wts["head"]).T
            return logits.argmax().to(torch.int32), logits

        return prefill

    def _build_paged_step(self, max_batch, max_blocks, block_size):
        """One continuous-batching decode step over the block pool.

        Feeds every slot's newest token at its own position, scatters
        the new K/V through each slot's block-table row, and attends
        over the gathered context.  Inactive slots ride along with
        ``n_past = 0`` and an all-scratch row: their writes land in
        block 0 and the host ignores their outputs, so the step needs
        NO liveness branch and one captured graph serves every
        admission and retirement.

        Returns ``step(wts, kpools, vpools, tables, n_past, tokens) ->
        (next_tokens, logits)`` (greedy argmax per slot): ``tables``
        (max_batch, max_blocks), ``n_past`` and ``tokens`` (max_batch,)
        are int64 tensors on the model's device.  It makes no host
        read, so it can be captured as a CUDA graph.
        """
        self._check_paged()
        d, h, kv, dh, rep, kvd = self._paged_dims()
        scale = math.sqrt(d)
        use_rope = self._pos_kind == "rope"
        max_len = self._max_len
        B, MB, bs = int(max_batch), int(max_blocks), int(block_size)
        C = MB * bs

        def step(wts, kpools, vpools, tables, n_past, tokens):
            x = _q_rows(wts["embed"], tokens) * scale          # (B, D)
            if not use_rope:
                x = x + _q_rows(wts["pos"], n_past.clamp(max=max_len - 1))
            blk = tables.gather(
                1, (n_past // bs).clamp(max=MB - 1)[:, None])[:, 0]
            off = n_past % bs
            keep = torch.arange(C, device=tokens.device)[None, :] \
                <= n_past[:, None]
            for li, lw in enumerate(wts["layers"]):
                xa = _jln(x, lw["ln1"])
                qkvm = xa @ _q_mat(lw["qkv"][0]).T + lw["qkv"][1]
                q = qkvm[:, :d].reshape(B, h, dh)
                k = qkvm[:, d:d + kvd].reshape(B, kv, dh)
                v = qkvm[:, d + kvd:].reshape(B, kv, dh)
                if use_rope:
                    q = _rope_rows(q, n_past)
                    k = _rope_rows(k, n_past)
                # every inactive slot writes block 0, offset 0: duplicate
                # indices, so which write lands there is not determined
                # on the card.  Harmless only because block 0 is never
                # unmasked for a live slot (the allocator never hands it
                # out, and lanes past a slot's own blocks are masked)
                kpools[li][blk, off] = k
                vpools[li][blk, off] = v
                kc = kpools[li][tables].reshape(B, C, kv, dh) \
                    .transpose(1, 2)                    # (B, kv, C, dh)
                vc = vpools[li][tables].reshape(B, C, kv, dh) \
                    .transpose(1, 2)
                qg = q.reshape(B, kv, rep, dh)
                s = torch.einsum("bkrd,bkcd->bkrc", qg, kc) / math.sqrt(dh)
                att = torch.softmax(
                    torch.where(keep[:, None, None, :], s, -1e9), dim=-1)
                o = torch.einsum("bkrc,bkcd->bkrd", att, vc).reshape(B, d)
                x = x + o @ _q_mat(lw["proj"][0]).T + lw["proj"][1]
                x = x + _ffn_rows(lw, None, _jln(x, lw["ln2"]))
            logits = _jln(x, wts["ln_f"]) @ _q_mat(wts["head"]).T
            return logits.argmax(-1).to(torch.int32), logits

        return step

    def decode_flops_per_token(self, context_len):
        """Matmul FLOPs to decode ONE token against a KV cache of
        ``context_len`` entries (forward only, no 3x rule)."""
        d = self._d
        mlp = self._mlp_flops()
        kvd = self.n_kv_heads * (d // self.n_heads)
        span = min(context_len, self.attn_window) \
            if self.attn_window else context_len
        per_layer = (2 * d * (d + 2 * kvd)
                     + 2 * d * d
                     + 2 * 2 * span * d
                     + mlp)
        return self.n_layers * per_layer + 2 * d * self.head.weight.shape[0]


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
