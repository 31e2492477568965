"""Standalone GPT config and parameters (counterpart of
``apex_tpu/transformer/testing/standalone_gpt.py``): config, parameters,
their partition specs, and the training forward and loss, on one device
or on this rank's shards under tensor and sequence parallelism.

The parameter tree keeps the JAX package's layout so weights carry across
one to one through :func:`apex_tpu_torch.convert.params_from_numpy`:

==============================  ==========================
``embed.tok``                   (vocab, hidden)
``embed.pos``                   (max_seq, hidden)
``layers.*`` (leading [L])      stacked per-layer tensors
``layers.qkv_kernel``           (hidden, 3·hidden), per-head interleaved
``layers.out_kernel``           (hidden, hidden)
``layers.fc1_kernel``           (hidden, ffn)
``layers.fc2_kernel``           (ffn, hidden)
``head.ln_w/ln_b``              (hidden,)
``head.lm`` (untied head)       (hidden, vocab)
==============================  ==========================

Training: :func:`gpt_loss` is the JAX ``gpt_loss`` — embedding, a Python
loop over the stacked layers (each under ``torch.utils.checkpoint`` when
``remat``, saving what ``remat_policy`` names), then either the fused
head (``fused_loss``, the default: final LayerNorm and
:func:`~apex_tpu_torch.ops.lm_head_loss.lm_head_loss` over the vocab rows,
kernels B #12-14 on the card) or the unfused one (final LayerNorm, the
vocab logits and the port's ``vocab_parallel_cross_entropy``).
LayerNorm, the attention core and the fused loss go through the port's
kernels; the projections are plain ``torch.matmul`` over the (b·s) rows.

Dropout (training mode, ``dropout_key`` given: a threefry ``uint32[2]``
key on the host, ``transformer.tensor_parallel.random``) follows JAX's
sites and keys: the embedding's hidden dropout under ``fold_in(key,
0x0E0B)``; layer i under ``fold_in(key, i)``, split in three for the
attention seed (the flash kernels' in-kernel dropout,
``attention_dropout_seed``, which folds the tp rank) and the two residual
branches' hidden dropout (``ops.dropout.hidden_dropout``, bitwise JAX's
``_hidden_dropout``), whose keys fold the sp rank under ring sp and the
tp rank under ``megatron_sp`` (``_hidden_key``). Without a key the model
runs in eval mode.

Tensor and sequence parallelism (JAX's program inside ``shard_map``). With
a mesh installed (``parallel_state.initialize_model_parallel`` or
``parallel.build_mesh``) the functions take this rank's LOCAL parameter
tree (:func:`shard_params` cuts it from the global one by
:func:`gpt_param_specs`) and, under ring sp, this rank's (b, s/sp) token
shard; they run JAX's tp layers (``tensor_parallel.layers``: the QKV and
FC1 column-parallel, split per head, the out-projection and FC2
row-parallel, the vocab-parallel embedding and the vocab-parallel loss,
``lm_head_loss(axis_name="tp")``), ``megatron_sp`` (sequence shards
between the tp blocks), ``overlap_comm`` (the ``comm.overlap`` rings) and
ring attention over ``sp``. The loss is this rank's mean over its tokens.
JAX sums the gradient of every replicated parameter over the axes its
cotangent varies on at the ``shard_map`` boundary; the port has no such
boundary, so the parameters that meet a sequence shard under
``megatron_sp`` (the LayerNorms, the row-parallel biases, the position
table) pass through ``copy_to_tensor_model_parallel_region`` (summed over
tp in backward, exactly once), and :func:`gather_grads` sums over dp and
sp (the data-parallel axes of the token shards) and gathers the tp
shards, the port's ``out_specs``. With no mesh every axis has one rank
and the functions are the single-device program.

Pipelines (``transformer.pipeline_parallel``): :func:`gpt_pipeline_spec`
gives the schedules' three functions over the untied tree of
:func:`gpt_pipeline_params_numpy` (JAX's ``[pp, L/pp, ...]`` or ``[vp,
pp, L/(vp·pp), ...]`` layout, specs :func:`gpt_pipeline_specs_tree`),
and :func:`gpt_pipeline_params` this rank's local tree of it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch._device import DeviceLike
from apex_tpu_torch.convert import params_from_numpy
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.dropout import hidden_dropout
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.ops.lm_head_loss import kernel_fits, lm_head_loss
from apex_tpu_torch.parallel.mesh import DP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS
from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineSpec,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    column_parallel_linear,
    row_parallel_linear,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_gather_dim,
    all_reduce,
    axis_info,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_sequence_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    attention_dropout_seed,
    checkpoint_saving,
    fold_in,
    model_parallel_key,
    pipeline_stage_key,
    saved_product,
    split,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import P

# the embedding's dropout stream, apart from the per-layer keys
_EMBED_DROPOUT_SALT = 0x0E0B


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """GPT-2-124M-class defaults: vocab 50304, hidden 768, 12 layers, 12
    heads (head_dim 64), max_seq 1024, bf16, tied embeddings.

    Training fields with the JAX meaning: ``remat`` (recompute each layer
    in backward), ``remat_policy`` (what a recomputed layer saves:
    ``"full"`` nothing, ``"dots"`` the products with no batch dimension —
    the qkv, out, fc1 and fc2 projections, marked by ``_dense`` — and
    ``"dots_attn"`` those and flash's forward outputs, so backward replays
    no attention forward),
    ``fused_loss`` (JAX's default ``True``: the LM head fused into the
    loss, kernels B #12-14 on the card; ``False`` materializes the
    logits), ``attention_dropout`` and ``hidden_dropout`` (active when the
    loss is given a ``dropout_key``), ``megatron_sp`` (Megatron's sequence
    shards over tp between the tp blocks), ``overlap_comm`` (the tp
    boundary collectives on ``comm.overlap``'s rings), ``num_experts``
    (> 0: every layer's FFN is ``transformer.moe``'s mixture of experts,
    experts over dp, the layer mean of the router loss added to the loss),
    ``moe_top_k``, ``moe_capacity_factor`` and ``moe_seq_dispatch``
    (under ``megatron_sp``, route each rank's sequence shard and gather
    the kept slots instead of the sequence). Left out, as TPU-only
    tuning: ``scan_unroll``, ``ln_pallas``, ``attn_block_q/k`` and
    ``lm_block_n/v``.
    """

    vocab_size: int = 50304
    max_seq: int = 1024
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_mult: int = 4
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = True
    remat: bool = True
    remat_policy: str = "full"
    fused_loss: bool = True
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    megatron_sp: bool = False
    overlap_comm: bool = False
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_seq_dispatch: bool = False

    @property
    def ffn_hidden(self) -> int:
        return self.ffn_mult * self.hidden

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    def validate(self, tp: int = 1, sp: int = 1) -> None:
        """JAX's checks for a tp × sp layout (and the port's dtypes); with
        ``num_experts``, :class:`~apex_tpu_torch.transformer.moe.MoEConfig`
        checks the routing fields."""
        if self.hidden % self.num_heads:
            raise ValueError("hidden must be divisible by num_heads")
        for name, dim in (("vocab_size", self.vocab_size),
                          ("num_heads", self.num_heads),
                          ("ffn_hidden", self.ffn_hidden)):
            if dim % tp:
                raise ValueError(f"{name} ({dim}) not divisible by tp ({tp})")
        if self.dtype not in (torch.float32, torch.bfloat16,
                              torch.float16):
            raise ValueError(f"dtype must be float32, bfloat16 or float16, "
                             f"got {self.dtype}")
        if self.remat_policy not in ("full", "dots", "dots_attn"):
            raise ValueError(
                f"remat_policy must be 'full', 'dots' or 'dots_attn', "
                f"got {self.remat_policy!r}")
        if self.megatron_sp and self.max_seq % tp:
            raise ValueError(
                f"megatron_sp needs max_seq ({self.max_seq}) divisible by "
                f"tp ({tp})")
        if self.overlap_comm and self.max_seq % (tp * sp):
            raise ValueError(
                f"overlap_comm rings shard the sp-local sequence by tp: "
                f"max_seq ({self.max_seq}) must be divisible by "
                f"tp*sp ({tp}*{sp})")
        if self.num_experts:
            self.moe_config  # MoEConfig.__post_init__ owns the MoE checks

    @property
    def moe_config(self):
        from apex_tpu_torch.transformer.moe import MoEConfig

        return MoEConfig(num_experts=self.num_experts, hidden=self.hidden,
                         ffn_hidden=self.ffn_hidden, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor,
                         dtype=self.dtype)


def init_gpt_params_numpy(cfg: GPTConfig, seed: int = 0
                          ) -> Dict[str, Any]:
    """The parameter tree as float32 numpy arrays, drawn from
    ``np.random.default_rng(seed)`` with the JAX package's scheme:
    normal(0.02) input projections and embeddings, output projections
    scaled by 1/sqrt(2L), zero biases, unit LN weights. With
    ``num_experts`` the FFN leaves are the experts' (JAX's shapes): a
    normal(0.02) ``router`` (L, h, E), which :func:`gpt_params_from_numpy`
    keeps fp32, and the fc kernels and biases with a leading ``E`` after
    ``L``."""
    cfg.validate()
    rng = np.random.default_rng(seed)
    h, f, L = cfg.hidden, cfg.ffn_hidden, cfg.num_layers
    out_std = 0.02 / math.sqrt(2.0 * L)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    params = {
        "embed": {"tok": normal((cfg.vocab_size, h), 0.02),
                  "pos": normal((cfg.max_seq, h), 0.02)},
        "layers": {
            "ln1_w": ones(L, h), "ln1_b": zeros(L, h),
            "qkv_kernel": normal((L, h, 3 * h), 0.02),
            "qkv_bias": zeros(L, 3 * h),
            "out_kernel": normal((L, h, h), out_std),
            "out_bias": zeros(L, h),
            "ln2_w": ones(L, h), "ln2_b": zeros(L, h),
        },
        "head": {"ln_w": ones(h), "ln_b": zeros(h)},
    }
    layers = params["layers"]
    if cfg.num_experts:
        e = cfg.num_experts
        layers.update(router=normal((L, h, e), 0.02),
                      fc1_kernel=normal((L, e, h, f), 0.02),
                      fc1_bias=zeros(L, e, f),
                      fc2_kernel=normal((L, e, f, h), out_std),
                      fc2_bias=zeros(L, e, h))
    else:
        layers.update(fc1_kernel=normal((L, h, f), 0.02),
                      fc1_bias=zeros(L, f),
                      fc2_kernel=normal((L, f, h), out_std),
                      fc2_bias=zeros(L, h))
    if not cfg.tie_embeddings:
        params["head"]["lm"] = normal((h, cfg.vocab_size), 0.02)
    return params


def _with_fp32_router(params, tree, convert, group: str = "layers"):
    """JAX initialises the MoE router fp32 whatever the model dtype (its
    logits feed softmax and top-k): ``params[group]["router"]``, cast with
    the other leaves, converted again from ``tree`` by ``convert`` with no
    dtype."""
    if "router" in tree.get(group, {}):
        sub = convert({group: {"router": tree[group]["router"]}})
        params[group]["router"] = sub[group]["router"]
    return params


def gpt_params_from_numpy(tree: Dict[str, Any], cfg: GPTConfig,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """A GPT or BERT tree of numpy arrays (:func:`init_gpt_params_numpy`'s,
    or JAX's taken to numpy) as ``cfg.dtype`` tensors on ``device``
    (default ``cuda``), the MoE router fp32."""
    return _with_fp32_router(
        params_from_numpy(tree, device, dtype=cfg.dtype), tree,
        lambda t: params_from_numpy(t, device))


def init_gpt_params(cfg: GPTConfig, seed: int = 0,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters from a numpy seed, as ``cfg.dtype`` tensors on
    ``device`` (default ``cuda``; the MoE router fp32)."""
    return gpt_params_from_numpy(init_gpt_params_numpy(cfg, seed), cfg,
                                 device)


def gpt_param_specs(cfg: GPTConfig) -> Dict[str, Any]:
    """Partition specs matching :func:`init_gpt_params` (JAX's
    ``gpt_param_specs``): the Megatron dims over tp (the stacked layer dim
    leads), everything else whole; with ``num_experts`` the experts over dp
    (``moe.moe_param_specs``: each rank owns E/dp experts)."""
    layer = {
        "ln1_w": P(None), "ln1_b": P(None),
        "qkv_kernel": P(None, None, TP_AXIS), "qkv_bias": P(None, TP_AXIS),
        "out_kernel": P(None, TP_AXIS, None), "out_bias": P(None),
        "ln2_w": P(None), "ln2_b": P(None),
    }
    if cfg.num_experts:
        from apex_tpu_torch.transformer.moe import moe_param_specs

        layer.update({k: P(None, *s)
                      for k, s in moe_param_specs(DP_AXIS).items()})
    else:
        layer.update({
            "fc1_kernel": P(None, None, TP_AXIS),
            "fc1_bias": P(None, TP_AXIS),
            "fc2_kernel": P(None, TP_AXIS, None), "fc2_bias": P(None)})
    specs = {"embed": {"tok": P(TP_AXIS, None), "pos": P()},
             "layers": layer, "head": {"ln_w": P(), "ln_b": P()}}
    if not cfg.tie_embeddings:
        specs["head"]["lm"] = P(None, TP_AXIS)
    return specs


def _spec_tree(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _spec_tree(v, specs[k], fn) for k, v in tree.items()}
    return fn(tree, specs)


def shard_params(params, specs):
    """This rank's local tree of a global parameter tree: each leaf cut
    along the dims its spec names by this rank's index on that axis of the
    current mesh (``shard_map``'s ``in_specs``). Leaves keep their
    ``requires_grad`` off: make the local leaves trainable."""
    def cut(t, spec):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            _, world, index = axis_info(axis)
            size = t.shape[dim] // world
            t = t.narrow(dim, index * size, size)
        return t.detach().contiguous()

    return _spec_tree(params, specs, cut)


def gather_grads(grads, specs):
    """The global gradient tree from this rank's local one (``shard_map``'s
    ``out_specs`` and the boundary's sum): each leaf summed over dp and sp
    (the axes the tokens are sharded on) where it is replicated over them,
    and gathered along the dims its spec names. An expert leaf is sharded
    over dp: its local gradient already holds every rank's tokens (the
    backward of the all-to-all), so it is gathered along ``E``, not
    summed. The same tree on every rank."""
    def assemble(g, spec):
        for axis in (DP_AXIS, SP_AXIS):
            if axis not in tuple(spec):
                g = all_reduce(g, axis)
        for dim, axis in enumerate(spec):
            if axis is not None:
                g = all_gather_dim(g, dim, axis)
        return g

    return _spec_tree(grads, specs, assemble)


# ---------------------------------------------------------------------------
# forward and loss (this rank's shards; with no mesh, one device)


def _tp() -> int:
    return axis_info(TP_AXIS)[1]


def _sp_param(w, cfg: GPTConfig):
    """A replicated parameter that meets this rank's sequence shard under
    ``megatron_sp``: its gradient is summed over tp once, in backward."""
    if cfg.megatron_sp:
        return copy_to_tensor_model_parallel_region(w)
    return w


def _dense(x, kernel, bias=None):
    """``x @ kernel (+ bias)`` over the (b·s) rows, in x's dtype, rounded
    after the product and after the bias add as the JAX column/row
    parallel linears are. The product is a "dots" output, saved by a
    remat policy that saves those."""
    y = saved_product(x, kernel)
    return y if bias is None else y + bias


def embed_tokens(embed, tokens, megatron_sp: bool = False):
    """Token + position embedding (JAX ``embed_tokens``): tokens (b, s_loc)
    (the sp shard under ring sp, positions offset by the sp rank) -> (b,
    s_loc, hidden), or with ``megatron_sp`` the (b, s_loc/tp, hidden)
    shard (the embedding's sum reduce-scattered along the sequence)."""
    s_loc = tokens.shape[1]
    _, tp, tp_rank = axis_info(TP_AXIS)
    _, sp, sp_rank = axis_info(SP_AXIS)
    if megatron_sp and s_loc % tp:
        raise ValueError(
            f"megatron_sp needs the sp-local sequence ({s_loc}) "
            f"divisible by tp ({tp})")
    h = vocab_parallel_embedding(tokens, embed["tok"],
                                 sequence_parallel=megatron_sp)
    start = sp_rank * s_loc
    pos = embed["pos"]
    if megatron_sp and tp > 1:
        s_loc //= tp
        start += tp_rank * s_loc
        pos = copy_to_tensor_model_parallel_region(pos)
    return h + pos[start:start + s_loc][None].to(h.dtype)


def _column(x, kernel, bias, cfg: GPTConfig):
    """A column-parallel projection of the tp layers (JAX's
    ``column_parallel_linear(gather_output=False)``), the product marked
    for the remat policies."""
    return column_parallel_linear(x, kernel, bias, gather_output=False,
                                  sequence_parallel=cfg.megatron_sp,
                                  overlap_comm=cfg.overlap_comm,
                                  product=saved_product)


def _row(x, kernel, bias, cfg: GPTConfig):
    """A row-parallel projection (``input_is_parallel``)."""
    return row_parallel_linear(x, kernel, bias, input_is_parallel=True,
                               sequence_parallel=cfg.megatron_sp,
                               overlap_comm=cfg.overlap_comm,
                               product=saved_product)


def _attention(p, x, cfg: GPTConfig, causal: bool = True, mask=None,
               dropout_key=None):
    """Column-parallel fused QKV, flash core, row-parallel out-projection
    (JAX ``_attention``). The QKV columns are per-head interleaved, (head,
    {q,k,v}, head_dim), so a tp column split hands each rank whole heads.
    Under ``megatron_sp`` ``x`` is the (b, s/tp, h) shard (gathered on
    entry, reduce-scattered on exit); over an sp axis of several ranks
    the core is :func:`ring_attention`. With ``dropout_key`` the kernels
    drop the attention probabilities at ``cfg.attention_dropout`` under
    ``attention_dropout_seed(dropout_key)`` (the tp rank folded in)."""
    b, s, _ = x.shape
    tp = _tp()
    if cfg.megatron_sp:
        s *= tp
    heads = cfg.num_heads // tp
    qkv = _column(x, p["qkv_kernel"], p["qkv_bias"], cfg)
    # (b, s, H, 3, D) -> (3, b, H, s, D): one copy, then q, k, v are
    # contiguous (b, H, s, D) views
    qkv = qkv.view(b, s, heads, 3, cfg.head_dim)
    q, k, v = qkv.permute(3, 0, 2, 1, 4).contiguous().unbind(0)
    rate = cfg.attention_dropout if dropout_key is not None else 0.0
    seed = attention_dropout_seed(dropout_key) if rate > 0.0 else None
    if axis_info(SP_AXIS)[1] > 1:
        if mask is not None:
            raise NotImplementedError(
                "explicit attention masks are not supported with sp > 1; "
                "use causal or full attention")
        from apex_tpu_torch.transformer.sequence_parallel import (
            ring_attention,
        )

        ctx = ring_attention(q, k, v, causal=causal, dropout_rate=rate,
                             dropout_seed=seed)
    elif rate > 0.0:
        ctx = flash_attention(q, k, v, causal=causal, mask=mask,
                              dropout_rate=rate, dropout_seed=seed)
    else:
        ctx = flash_attention(q, k, v, causal=causal, mask=mask)
    ctx = ctx.transpose(1, 2).reshape(b, s, heads * cfg.head_dim)
    return _row(ctx, p["out_kernel"], p["out_bias"], cfg)


def _mlp(p, x, cfg: GPTConfig):
    """-> ``(out, aux)`` (JAX ``_mlp``). Dense: column-parallel FC1 +
    tanh-approximated GELU + row-parallel FC2, ``aux`` None. With
    ``cfg.num_experts`` the FFN is ``moe.moe_mlp`` (experts over dp) and
    ``aux`` its weighted router loss, on JAX's three branches: plain;
    under ``megatron_sp`` the sequence gathered for the MoE region (every
    tp rank then computes the same region, so the gather's backward keeps
    this rank's slice) and the shard sliced back out; with
    ``moe_seq_dispatch`` too, each rank routes its own shard
    (``seq_shard_axis``), the router's gradient summed over tp, and the
    per-shard router loss averaged over tp (the loss stays the same on
    every tp rank)."""
    if cfg.num_experts:
        from apex_tpu_torch.transformer.moe import moe_mlp

        mcfg = cfg.moe_config
        if cfg.megatron_sp and cfg.moe_seq_dispatch:
            p = dict(p, router=copy_to_tensor_model_parallel_region(
                p["router"]))
            out, aux = moe_mlp(p, x, mcfg, ep_axis=DP_AXIS,
                               seq_shard_axis=TP_AXIS)
            loss = aux["loss"]
            if _tp() > 1:
                loss = reduce_from_tensor_model_parallel_region(loss) / _tp()
            return out, loss
        if cfg.megatron_sp:
            x = gather_from_sequence_parallel_region(
                x, tensor_parallel_output_grad=False)
            out, aux = moe_mlp(p, x, mcfg, ep_axis=DP_AXIS)
            return scatter_to_sequence_parallel_region(out), aux["loss"]
        out, aux = moe_mlp(p, x, mcfg, ep_axis=DP_AXIS)
        return out, aux["loss"]
    y = F.gelu(_column(x, p["fc1_kernel"], p["fc1_bias"], cfg),
               approximate="tanh")
    return _row(y, p["fc2_kernel"], p["fc2_bias"], cfg), None


def _hidden_key(key, cfg: GPTConfig):
    """JAX's hidden-dropout key policy: the sp rank folded in under ring sp
    and the tp rank (``model_parallel_key``) under ``megatron_sp``, where
    ranks hold different tokens; the attention stream stays unfolded by
    sp (its hash is keyed by global positions)."""
    if key is None:
        return key
    _, sp, sp_rank = axis_info(SP_AXIS)
    if sp > 1:
        key = fold_in(key, sp_rank)
    if cfg.megatron_sp:
        key = model_parallel_key(key)
    return key


def _layer(p, x, cfg: GPTConfig, causal: bool = True, mask=None,
           dropout_key=None):
    """Pre-LN transformer layer (JAX ``_layer``): attention (with in-kernel
    attention dropout) -> hidden dropout -> residual; MLP -> hidden dropout
    -> residual. ``dropout_key`` splits in three: attention, then each
    branch's hidden dropout. Returns ``(x, aux)`` (``_mlp``'s aux)."""
    k_attn = k_h1 = k_h2 = None
    if dropout_key is not None:
        k_attn, k_h1, k_h2 = split(dropout_key, 3)
        k_h1, k_h2 = _hidden_key(k_h1, cfg), _hidden_key(k_h2, cfg)
    ln1 = [_sp_param(p[k], cfg) for k in ("ln1_w", "ln1_b")]
    a = _attention(p, layer_norm(x, *ln1), cfg, causal, mask,
                   dropout_key=k_attn)
    if k_h1 is not None and cfg.hidden_dropout > 0.0:
        a = hidden_dropout(a, cfg.hidden_dropout, k_h1)
    x = x + a
    ln2 = [_sp_param(p[k], cfg) for k in ("ln2_w", "ln2_b")]
    m, aux = _mlp(p, layer_norm(x, *ln2), cfg)
    if k_h2 is not None and cfg.hidden_dropout > 0.0:
        m = hidden_dropout(m, cfg.hidden_dropout, k_h2)
    return x + m, aux


def dots_attn_policy():
    """What the ``"dots_attn"`` policy saves: the products with no batch
    dimension (``"dots"``) and flash's forward outputs (``"attn"``), o and
    lse both, as JAX names ``attn_out`` and ``attn_lse``, or backward would
    replay the forward kernel for lse."""
    return ("dots", "attn")


# what a recomputed layer saves under each remat_policy
_REMAT_SAVES = {"full": (), "dots": ("dots",), "dots_attn": dots_attn_policy()}


def _layer_stack(layers, x, cfg: GPTConfig, causal: bool = True, mask=None,
                 dropout_key=None):
    """The JAX ``lax.scan`` over the stacked layer params as a Python loop;
    with ``cfg.remat`` (and autograd recording) each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in backward, saving what
    ``cfg.remat_policy`` names. Layer i's dropout key is ``fold_in(key,
    i)`` (the key first folded by the pp rank over a pipeline of several
    stages, as JAX's), an argument of the recomputed function, so the
    recompute drops the same elements. The stacked leaves are unbound
    once, so their gradients are stacked once in backward. Returns ``(x,
    aux)``: the layer mean of the MoE router loss (fp32), None for a
    dense FFN."""
    tp = _tp()
    if cfg.num_heads % tp:
        raise ValueError(
            f"num_heads ({cfg.num_heads}) not divisible by tp ({tp}); "
            f"see GPTConfig.validate(tp=...)")
    if cfg.overlap_comm and not cfg.megatron_sp and x.shape[1] % tp:
        raise ValueError(
            f"overlap_comm rings shard the sequence: local sequence "
            f"({x.shape[1]}) not divisible by tp ({tp}); see "
            f"GPTConfig.validate(tp=..., sp=...)")
    if dropout_key is not None and axis_info(PP_AXIS)[1] > 1:
        # each stage holds other layers under the same local indices:
        # decorrelate by the stage rank, as JAX folds axis_index(pp)
        dropout_key = pipeline_stage_key(dropout_key)
    names = sorted(layers)
    per_leaf = [layers[k].unbind(0) for k in names]
    one = _layer
    if cfg.remat and torch.is_grad_enabled():
        one = checkpoint_saving(_layer, _REMAT_SAVES[cfg.remat_policy])
    auxes = []
    for i, vals in enumerate(zip(*per_leaf)):
        key = None if dropout_key is None else fold_in(dropout_key, i)
        x, aux = one(dict(zip(names, vals)), x, cfg, causal, mask, key)
        if aux is not None:
            auxes.append(aux)
    return x, (torch.stack(auxes).mean() if auxes else None)


def _embed_with_dropout(embed, tokens, cfg: GPTConfig, dropout_key):
    """The embedding, then (training) its hidden dropout under
    ``fold_in(key, 0x0E0B)``, a stream apart from the layers'."""
    x = embed_tokens(embed, tokens, megatron_sp=cfg.megatron_sp)
    if dropout_key is not None and cfg.hidden_dropout > 0.0:
        x = hidden_dropout(x, cfg.hidden_dropout, _hidden_key(
            fold_in(dropout_key, _EMBED_DROPOUT_SALT), cfg))
    return x


def tied_vocab_logits(x, tok_embed, megatron_sp: bool = False):
    """The tied LM head: logits = x @ tokᵀ against this rank's vocab rows,
    (b, s, vocab/tp) in x's dtype; under ``megatron_sp`` the sequence is
    gathered first (whose backward reduce-scatters the ranks' partial
    cotangents, in place of the copy mapping's all-reduce)."""
    return torch.matmul(_enter_vocab_region(x, megatron_sp), tok_embed.t())


def _enter_vocab_region(x, megatron_sp: bool):
    """The activations entering the vocab-sharded head: gathered along the
    sequence under ``megatron_sp``, else marked replicated (copy); either
    backward sums the ranks' partial cotangents once."""
    if megatron_sp:
        return gather_from_sequence_parallel_region(x)
    return copy_to_tensor_model_parallel_region(x)


def gpt_head(params, x, cfg: GPTConfig):
    """Final LN + LM head -> vocab-sharded logits (b, s, vocab/tp)."""
    head = params["head"]
    x = layer_norm(x, *(_sp_param(head[k], cfg) for k in ("ln_w", "ln_b")))
    if cfg.tie_embeddings:
        return tied_vocab_logits(x, params["embed"]["tok"], cfg.megatron_sp)
    if cfg.megatron_sp:
        x = gather_from_sequence_parallel_region(x)
    return column_parallel_linear(x, head["lm"], gather_output=False,
                                  product=saved_product)


def gpt_forward(params, tokens, cfg: GPTConfig, dropout_key=None):
    """tokens (b, s) -> logits (b, s, vocab/tp). ``dropout_key`` (a
    threefry ``uint32[2]``) turns on cfg's dropout rates: training mode."""
    cfg.validate()
    x = _embed_with_dropout(params["embed"], tokens, cfg, dropout_key)
    x, _ = _layer_stack(params["layers"], x, cfg, dropout_key=dropout_key)
    return gpt_head(params, x, cfg)


def _use_fused_loss(cfg: GPTConfig, n_rows: int,
                    device: torch.device) -> bool:
    """The JAX ``_use_fused_loss``: the fused head where ``cfg.fused_loss``
    asks for it and, on the card, the kernel's shape gate holds
    (:func:`kernel_fits`, JAX's ``pallas_fits``); on the CPU always, as
    JAX runs its dense version off the TPU."""
    if not cfg.fused_loss:
        return False
    if device.type == "cpu":
        return True
    return kernel_fits(n_rows, cfg.hidden)


def fused_head_loss(head_rows_w, ln_w, ln_b, x, targets,
                    gather_sequence: bool = False):
    """Final LayerNorm, then the fused LM-head + CE over this rank's
    (vocab/tp, hidden) projection rows ``head_rows_w``: the mean loss, 0-d
    fp32 (JAX ``fused_head_loss``). With ``gather_sequence``
    (megatron_sp) the LN runs on the sequence shard, whose parameters'
    gradients are then summed over tp, and the sequence is gathered
    before the head."""
    if gather_sequence:
        ln_w = copy_to_tensor_model_parallel_region(ln_w)
        ln_b = copy_to_tensor_model_parallel_region(ln_b)
    x = _enter_vocab_region(layer_norm(x, ln_w, ln_b), gather_sequence)
    return lm_head_loss(x, head_rows_w, targets,
                        axis_name=TP_AXIS).mean()


def gpt_loss(params, tokens, targets, cfg: GPTConfig, dropout_key=None):
    """Mean cross-entropy of the next-token logits (the JAX ``gpt_loss``):
    a 0-d fp32 tensor. With ``cfg.fused_loss`` (and the kernel's shape
    gate on the card) the head is fused into the loss and the logits are
    never materialized; otherwise logits + ``vocab_parallel_cross_entropy``.
    With ``cfg.num_experts`` the layer mean of the router loss is added.
    ``dropout_key`` (a threefry ``uint32[2]``, JAX's key data) turns on
    cfg's dropout rates; None is eval mode. Under a mesh: this rank's
    local parameters and token shard, the mean over this rank's tokens.
    """
    cfg.validate()
    x = _embed_with_dropout(params["embed"], tokens, cfg, dropout_key)
    x, aux = _layer_stack(params["layers"], x, cfg, dropout_key=dropout_key)
    if not _use_fused_loss(cfg, tokens.numel(), tokens.device):
        logits = gpt_head(params, x, cfg)
        loss = vocab_parallel_cross_entropy(logits, targets).mean()
    else:
        head = params["head"]
        w = (params["embed"]["tok"] if cfg.tie_embeddings
             else head["lm"].t())  # (vocab/tp, hidden) rows
        loss = fused_head_loss(w, head["ln_w"], head["ln_b"], x, targets,
                               gather_sequence=cfg.megatron_sp)
    return loss if aux is None else loss + aux


# ---------------------------------------------------------------------------
# pipeline wiring (the PipelineSpec contract, pipeline_parallel.schedules)


def gpt_pipeline_params_numpy(cfg: GPTConfig, pp: int, vp: int = None,
                              seed: int = 0) -> Dict[str, Any]:
    """:func:`init_gpt_params_numpy` regrouped into the pipeline drivers'
    global layout (JAX's ``gpt_pipeline_params``): ``{"embed", "stages"
    [pp, L/pp, ...], "head"}``, or ``[vp, pp, L/(vp·pp), ...]`` for the
    interleaved schedule (chunk ``v`` on stage ``s`` holds depth block
    ``v·pp + s``). The LM head is untied: embedding and head live on
    different stages."""
    chunks = pp * (vp or 1)
    if cfg.num_layers % chunks:
        raise ValueError("num_layers must be divisible by pp * vp")
    flat = init_gpt_params_numpy(
        dataclasses.replace(cfg, tie_embeddings=False), seed)
    per = cfg.num_layers // chunks
    lead = (pp, per) if vp is None else (vp, pp, per)
    stages = {k: v.reshape(lead + v.shape[1:])
              for k, v in flat["layers"].items()}
    return {"embed": flat["embed"], "stages": stages, "head": flat["head"]}


def gpt_pipeline_params(cfg: GPTConfig, pp: int, vp: int = None,
                        seed: int = 0, device: DeviceLike = None
                        ) -> Dict[str, Any]:
    """This rank's local pipeline tree (its stage, or its ``[vp, ...]``
    chunk stack, and its tp shards on the current mesh) of
    :func:`gpt_pipeline_params_numpy`, as ``cfg.dtype`` tensors on
    ``device`` (the MoE router fp32): the schedules' ``params``."""
    from apex_tpu_torch.convert import pipeline_params_from_numpy

    tree = gpt_pipeline_params_numpy(cfg, pp, vp, seed)
    specs = gpt_pipeline_specs_tree(cfg, interleaved=vp is not None)
    return _with_fp32_router(
        pipeline_params_from_numpy(tree, device, dtype=cfg.dtype,
                                   specs=specs), tree,
        lambda t: pipeline_params_from_numpy(t, device, specs=specs),
        "stages")


def gpt_pipeline_specs_tree(cfg: GPTConfig, interleaved: bool = False
                            ) -> Dict[str, Any]:
    """Partition specs of :func:`gpt_pipeline_params_numpy` (JAX's): the
    layer specs of :func:`gpt_param_specs` with the stage axis (``[pp]``,
    or ``[vp, pp]``) in front."""
    lead = (None, PP_AXIS) if interleaved else (PP_AXIS,)
    base = gpt_param_specs(dataclasses.replace(cfg, tie_embeddings=False))
    stages = {k: P(*lead, *spec) for k, spec in base["layers"].items()}
    return {"embed": base["embed"], "stages": stages, "head": base["head"]}


def gpt_pipeline_spec(cfg: GPTConfig, dropout: bool = False) -> PipelineSpec:
    """The three pipeline functions (JAX's ``gpt_pipeline_spec``). With
    ``dropout`` the embed and stage functions take the schedules'
    per-microbatch key (``takes_dropout_key``) and apply cfg's dropout
    rates; pass ``dropout_key=`` to the driver. With ``cfg.num_experts``
    the stage function also yields its layers' router loss
    (``stage_aux``); pass the driver ``params_specs=
    gpt_pipeline_specs_tree(cfg)`` so the expert gradients are not summed
    over dp. The loss is the fused
    LM head over the untied head rows where ``_use_fused_loss`` allows it
    for the rows the kernel sees (the sequence gathered over tp under
    ``megatron_sp``), else the unfused vocab-parallel loss."""
    cfg.validate()
    untied = dataclasses.replace(cfg, tie_embeddings=False)

    def _stage_out(out_aux):
        # with experts the stage yields its layers' router loss too
        # (stage_aux), which the schedules average and add
        out, aux = out_aux
        return (out, aux) if cfg.num_experts else out

    if dropout:
        def embed_fn(embed, tokens, key):
            return _embed_with_dropout(embed, tokens, cfg, key)

        def stage_fn(stage_layers, h, key):
            return _stage_out(_layer_stack(stage_layers, h, cfg,
                                           dropout_key=key))
    else:
        def embed_fn(embed, tokens):
            return embed_tokens(embed, tokens, megatron_sp=cfg.megatron_sp)

        def stage_fn(stage_layers, h):
            return _stage_out(_layer_stack(stage_layers, h, cfg))

    def loss_fn(head, h, targets):
        rows = h.shape[0] * h.shape[1]
        if cfg.megatron_sp:
            rows *= _tp()
        if _use_fused_loss(cfg, rows, h.device):
            return fused_head_loss(head["lm"].t(), head["ln_w"],
                                   head["ln_b"], h, targets,
                                   gather_sequence=cfg.megatron_sp)
        logits = gpt_head({"head": head}, h, untied)
        return vocab_parallel_cross_entropy(logits, targets).mean()

    return PipelineSpec(embed_fn=embed_fn, stage_fn=stage_fn, loss_fn=loss_fn,
                        stage_aux=bool(cfg.num_experts),
                        takes_dropout_key=dropout)
