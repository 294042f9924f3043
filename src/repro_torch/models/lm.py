"""The transformer LM of the dense, moe, audio and vlm families: training
loss, prefill forward (plain or flash attention) and KV-cache decode.

The JAX package's ``models/lm.py`` as an ``nn.Module``: embedding table
(none where ``not cfg.embed_inputs``: the audio family), a ``ModuleList``
of pre-norm blocks, final norm, and an output head that is the embedding
table itself when ``cfg.tie_embeddings`` and there is one. A block's
attention is GQA (``layers.Attention``)
or, with ``cfg.use_mla``, latent attention (``mla.MLA``); its FFN is a
SwiGLU, or with ``cfg.n_experts`` a mixture of experts (``moe.MoE``) plus
a shared SwiGLU of ``moe_d_ff * n_shared_experts``. The reference stacks
its layers and scans over them; here the layers are a Python loop.

  LM(cfg).init_(generator)              random weights at the reference's scales
  abstract_init(cfg)                    the LM on the ``meta`` device (shapes only)
  loss_fn(cfg, lm, batch, remat=...)    masked cross entropy, differentiable
  forward(cfg, lm, batch, flash=...)    -> logits (B, S, vocab), no gradient
  init_cache(cfg, B, max_len)           -> (cache, axes)
  decode_step(cfg, lm, cache, tok, pos) -> (logits (B, 1, vocab), cache)

Training and serving share one layer loop (:func:`forward_train`, which
records gradients); ``forward`` runs it under ``torch.no_grad``. Tables
are ``cfg.padded_vocab`` wide and logits are sliced back to
``cfg.vocab_size``. ``remat`` ("none", "full", "dots") chooses what the
backward pass recomputes and changes no value. The ssm and hybrid
families have models of their own (``ssm_lm.py``, ``hybrid.py``).

Batches, as in the reference:

  dense, moe : tokens (B, S) int, labels (B, S)
  audio      : frames (B, S, D) float (the frontend's output), labels (B, S);
               not causal, no rotary embedding, no decode step
  vlm        : tokens (B, S - P), patches (B, P, D) float, positions
               (3, B, S) int (M-RoPE's streams), labels (B, S) with -100
               over the P patches

A vlm decode step embeds text only and turns all three M-RoPE streams by
the cache index, as the reference's does.

``mesh`` is ``None``, a mesh of one card or a ``DeviceMesh`` (``launch.
mesh``). With a mesh the moe family's layers take the expert-parallel
path with its capacity drops, as the reference's do. Across the ranks of
a ``DeviceMesh`` every rank passes the same batch and the same weights
(plain tensors, or DTensors placed by the partition rules: a placed
batch or cache leaf is read as the rank's share, ``layers.local_rows``),
and each rank runs its block of the batch rows (``layers.batch_rows``) through
layers that are tensor parallel over "model" (``layers.tp_weights``):
the embedding table is split by vocabulary rows (a masked local lookup,
the ranks' rows summed), attention by heads (the flash prefill launches
the kernel on the rank's heads), the FFN by its hidden columns, the MoE
by experts with all-to-alls (``moe.moe_apply_ep``), and the head by
vocabulary columns: each rank computes its rows' logits for its block of
the padded vocabulary's columns (``B_loc x S x padded_vocab / tp``
values of the compute type) and never the whole vocabulary.
:func:`forward` and :func:`decode_step` return the logits as a DTensor
placed as the reference places them (:func:`place_logits`): rows split
over the data axes as the batch's, the vocabulary split over "model" in
even blocks where the TP degree divides it and whole otherwise; a caller
that needs the whole logits calls ``.full_tensor()``. :func:`loss_fn` is
the global masked mean of a vocab-parallel cross entropy
(:func:`vocab_parallel_nll`), its numerator and its count summed over
the data axes before the division.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from . import layers as L
from . import mla as MLA
from . import moe as MOE

__all__ = ["LM", "Block", "check_ported", "abstract_init", "forward",
           "forward_train", "forward_rows", "embed_tokens", "place_logits", "cross_entropy", "vocab_parallel_nll",
           "ranked_loss", "loss_fn", "init_cache",
           "decode_step", "REMAT", "check_remat", "remat_apply"]

REMAT = ("none", "full", "dots")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the families this LM builds."""
    if cfg.family not in ("dense", "moe", "audio", "vlm") \
            or (cfg.family == "dense" and cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not an LM of the port; "
            f"the LM builds the dense, moe, audio and vlm families (GQA or "
            f"MLA attention), and the ssm and hybrid families have models "
            f"of their own (models/ssm_lm.py, models/hybrid.py)")


class Block(nn.Module):
    """One pre-norm layer: h + attn(norm(h)), then h + ffn(norm(h)).
    ``attn`` is MLA or GQA; the FFN is ``moe`` (+ ``shared`` where the
    config has shared experts) or ``ffn``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = L.dtype_of(cfg.param_dtype)
        self.attn = (MLA.MLA(cfg, device=device) if cfg.use_mla
                     else L.Attention(cfg, device=device))
        if cfg.n_experts:
            self.moe = MOE.MoE(cfg, device=device)
            if cfg.n_shared_experts:
                self.shared = L.SwiGLU(
                    cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts,
                    device=device)
        else:
            self.ffn = L.SwiGLU(cfg, device=device)
        self.norm_attn = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.norm_ffn = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)

    def init_(self, generator: torch.Generator) -> None:
        for name in ("attn", "moe", "shared", "ffn"):
            if hasattr(self, name):
                getattr(self, name).init_(generator)


class LM(nn.Module):
    """Parameters of a dense, moe, audio or vlm LM. Weights are created on
    ``device`` without values; :meth:`init_` draws them, ``models.carry``
    loads them. ``embed`` is None where ``not cfg.embed_inputs``, ``head``
    where the head is the embedding table."""

    AXES = L.TABLE_AXES

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dt = L.dtype_of(cfg.param_dtype)
        self.embed = (L.empty_weight((cfg.padded_vocab, cfg.d_model), dt,
                                     device) if cfg.embed_inputs else None)
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.norm_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.head = (None if _tied(cfg) else
                     L.empty_weight((cfg.d_model, cfg.padded_vocab), dt,
                                    device))

    def init_(self, generator: torch.Generator) -> "LM":
        """Random weights at the reference's scales: embedding N(0, 0.02),
        dense weights N(0, 2 / (in + out)), norms one. The draws differ
        from ``jax.random``'s; the parity tests carry weights over."""
        with torch.no_grad():
            if self.embed is not None:
                self.embed.normal_(0.0, 0.02, generator=generator)
            for blk in self.layers:
                blk.init_(generator)
            if self.head is not None:
                L.dense_init_(self.head, generator)
        return self


def abstract_init(cfg: ModelConfig) -> LM:
    """The LM on the ``meta`` device: every parameter's shape and type,
    no storage (the reference's ``abstract_init``)."""
    return LM(cfg, device="meta")


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _ffn_block(cfg: ModelConfig, lp: Block, h_norm: torch.Tensor,
               mesh=None, ref: Optional[DTensor] = None) -> torch.Tensor:
    """The FFN on h_norm (B, S, D); across ranks h_norm holds the rank's
    rows of the batch, placed as the DTensor ``ref`` says
    (``layers.rows_of``), and the MoE sees every token as a DTensor placed
    like those rows (or, at an EP degree of 1, the rank's own tokens)."""
    if not cfg.n_experts:
        return L.swiglu_apply(lp.ffn, h_norm, mesh)
    B, S, D = h_norm.shape
    tokens = h_norm.reshape(B * S, D)
    if mesh is None:
        y = MOE.moe_apply_dense(cfg, lp.moe, tokens)
    elif ref is None or (L._tp(mesh)[0] == 1 and L.rows_split(ref)):
        # one card, or an EP degree of 1 over rows that are the rank's own
        # tokens: the body runs on them as on one card
        y = MOE.moe_apply_ep(cfg, lp.moe, tokens, mesh)
    else:
        y = MOE.moe_apply_ep(cfg, lp.moe, L.rows_like(
            tokens, ref, ref.shape[0] * S), mesh).to_local()
    if cfg.n_shared_experts:
        y = y + L.swiglu_apply(lp.shared, tokens, mesh)
    return y.reshape(B, S, D)


def _layer_apply(cfg: ModelConfig, lp: Block, h: torch.Tensor,
                 positions: Optional[torch.Tensor], mesh=None,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 cache_index: Optional[int] = None, flash: bool = False,
                 mrope: Optional[torch.Tensor] = None,
                 ref: Optional[DTensor] = None, cache_seq=None):
    """One block on h (B, S, D). ``positions`` (B, S) drive RoPE,
    ``mrope`` (3, B, S) M-RoPE (vlm; ``positions`` is then None). Across
    ranks h is the rank's rows of the batch, placed as ``ref`` says;
    ``cache_seq`` as ``layers.attention_apply`` takes it."""
    h_norm = lp.norm_attn(h)
    if cfg.use_mla:
        # MLA has no flash branch, in the reference as here
        attn_out, new_cache = MLA.mla_apply(
            cfg, lp.attn, h_norm, positions, cache=cache,
            cache_index=cache_index, mesh=mesh)
    else:
        attn_out, new_cache = L.attention_apply(
            cfg, lp.attn, h_norm, positions, mrope_positions=mrope,
            cache=cache, cache_index=cache_index, mesh=mesh, flash=flash,
            cache_seq=cache_seq)
    h = h + attn_out
    h = h + _ffn_block(cfg, lp, lp.norm_ffn(h), mesh, ref)
    return h, new_cache


def embed_tokens(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Rows of the embedding ``table`` for ``tokens``, in the compute type.
    A table split over "model" by vocabulary rows (``layers.tp_weights``)
    looks up the tokens it holds, zeros for the others, and the ranks'
    rows are summed."""
    dt = L.dtype_of(cfg.compute_dtype)
    V_loc = table.shape[0]
    if V_loc == cfg.padded_vocab:
        return table[tokens].to(dt)
    _, idx = L._tp(mesh)
    ids = tokens.long() - idx * V_loc
    inside = (ids >= 0) & (ids < V_loc)
    rows = table[ids.clamp(0, V_loc - 1)].to(dt)
    return L.tp_reduce(torch.where(inside[..., None], rows, 0.0).to(dt),
                       mesh)


def _batch_size(batch: Dict) -> int:
    return next(batch[k] for k in ("tokens", "frames")
                if k in batch).shape[0]


def _embed_batch(cfg: ModelConfig, lm: LM, batch: Dict, mesh=None,
                 rows: slice = slice(None)):
    """-> (h (B, S, D) in the compute type, positions (B, S) or None,
    M-RoPE positions (3, B, S) or None) of the batch's ``rows``. audio:
    the frames; vlm: the patches followed by the embedded text, with the
    batch's M-RoPE streams; otherwise the embedded tokens."""
    dt = L.dtype_of(cfg.compute_dtype)
    if cfg.family == "vlm":
        text = embed_tokens(cfg, lm.embed,
                            L.local_rows(batch["tokens"], rows), mesh)
        h = torch.cat([L.local_rows(batch["patches"], rows).to(dt), text],
                      dim=1)
        return h, None, L.local_rows(batch["positions"], rows, 1)
    h = (L.local_rows(batch["frames"], rows).to(dt)
         if cfg.family == "audio" else
         embed_tokens(cfg, lm.embed, L.local_rows(batch["tokens"], rows),
                      mesh))
    B, S = h.shape[:2]
    return h, torch.arange(S, device=h.device)[None, :].expand(B, S), None


def _tied(cfg: ModelConfig) -> bool:
    """Whether the head is the embedding table (the reference's rule: a
    model without an embedding table has a head of its own)."""
    return cfg.tie_embeddings and cfg.embed_inputs


def _head(cfg: ModelConfig, lm: LM, h: torch.Tensor,
          mesh=None) -> torch.Tensor:
    """Logits of h. A head split over "model" by vocabulary columns
    (``layers.tp_weights``) gives the rank's block of the padded
    vocabulary's columns (its input passes ``layers.tp_enter``); a whole
    head gives the logits sliced to ``cfg.vocab_size``."""
    w = lm.embed.T if _tied(cfg) else lm.head
    if w.shape[-1] == cfg.padded_vocab:
        # tables are padded to cfg.padded_vocab
        return (h @ w.to(h.dtype))[..., :cfg.vocab_size]
    return L.tp_enter(h, mesh) @ w.to(h.dtype)


def _vocab_split(cfg: ModelConfig, logits: torch.Tensor, mesh) -> bool:
    """Whether ``logits`` (:func:`_head`) are the rank's block of a head
    split over "model": a whole head at a TP degree above 1 gives
    ``vocab_size`` columns, which never equal ``padded_vocab / tp``
    (that degree would divide the padded table, and split it)."""
    tp, _ = L._tp(mesh)
    return tp > 1 and logits.shape[-1] * tp == cfg.padded_vocab


def place_logits(cfg: ModelConfig, logits: torch.Tensor, mesh,
                 n: int) -> DTensor:
    """The serving output across the ranks of a DeviceMesh from this
    rank's rows' ``logits`` (:func:`_head`) of a batch of ``n``, placed
    as the reference places its logits: the rows as the batch's
    (``Shard(0)`` over the data axes that split them), and over "model"
    ``Shard(2)`` in even blocks of ``vocab_size / tp`` columns where the
    TP degree divides the vocabulary or ``Replicate()`` of the whole
    vocabulary otherwise (``layers.vocab_blocks``): the reference's
    ``P(dp, None, "model" if vocab_size % tp == 0 else None)``."""
    tp, _ = L._tp(mesh)
    even = cfg.vocab_size % tp == 0
    if _vocab_split(cfg, logits, mesh):
        logits = L.vocab_blocks(logits, cfg.vocab_size, mesh)
    where = tuple(Shard(logits.dim() - 1) if a == "model" and even else p
                  for a, p in zip(mesh.mesh_dim_names,
                                  L._row_placements(mesh, n)))
    return L.local_as(logits, mesh, where, (n,) + tuple(logits.shape[1:-1])
                      + (cfg.vocab_size,))


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------

def _save_projections(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    the projection products (``aten.mm``: ``x @ w`` with no batch
    dimension) and recompute everything else, attention's batched
    products included. The counterpart of JAX's
    ``checkpoint_dots_with_no_batch_dims``."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def check_remat(remat: str, grad: bool = True) -> None:
    """``remat`` must be one of REMAT, and "none" where no gradient is
    taken (a forward for serving)."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: choose from {REMAT}")
    if not grad and remat != "none":
        raise NotImplementedError(
            f"remat={remat!r}: rematerialisation only applies where "
            f"gradients are taken; train through loss_fn")


def remat_apply(body, h: torch.Tensor, remat: str) -> torch.Tensor:
    """``body(h)``, one layer, keeping for the backward pass what
    ``remat`` says: "none" every activation, "full" the layer's input
    only, "dots" also the projections' outputs (``torch.utils.checkpoint``,
    non-reentrant)."""
    if remat == "none":
        return body(h)
    if remat == "full":
        return ckpt.checkpoint(body, h, use_reentrant=False)
    return ckpt.checkpoint(body, h, use_reentrant=False,
                           context_fn=functools.partial(
                               ckpt.create_selective_checkpoint_contexts,
                               _save_projections))


def _one_card(mesh, what: str) -> None:
    if L.ranked(mesh):
        raise ValueError(f"{what} runs on one card; across the ranks of a "
                         f"DeviceMesh use forward_rows")


def forward_train(cfg: ModelConfig, lm: LM, batch: Dict, mesh=None,
                  remat: str = "none", flash: bool = False) -> torch.Tensor:
    """Logits (B, S, vocab) in the compute type on one card (``mesh`` None
    or a mesh of one card), recording gradients for whichever weights
    require them, each layer under :func:`remat_apply`. Across the ranks
    of a DeviceMesh, :func:`forward_rows` gives each rank its block."""
    check_remat(remat)
    _one_card(mesh, "forward_train")
    h, positions, mrope = _embed_batch(cfg, lm, batch)
    for lp in lm.layers:
        h = remat_apply(lambda h, lp=lp: _layer_apply(
            cfg, lp, h, positions, mesh, flash=flash, mrope=mrope)[0], h,
            remat)
    h = lm.norm_f(h)
    return _head(cfg, lm, h)


def forward_rows(cfg: ModelConfig, lm: LM, batch: Dict, mesh,
                 remat: str = "none", flash: bool = False):
    """Across the ranks of a DeviceMesh (see the module's note): (this
    rank's rows' logits as :func:`_head` gives them, (B_loc, S,
    padded_vocab / tp) where the head is split and (B_loc, S, vocab)
    where it is whole; those rows of the batch)."""
    B = _batch_size(batch)
    rows = L.batch_rows(B, mesh)
    with L.tp_weights(lm, mesh, skip=("layers",)):
        h, positions, mrope = _embed_batch(cfg, lm, batch, mesh, rows)
        ref = L.rows_of(h.detach(), mesh, B)
        for lp in lm.layers:
            h = remat_apply(L.tp_body(lp, mesh, lambda lp, h: _layer_apply(
                cfg, lp, h, positions, mesh, flash=flash, mrope=mrope,
                ref=ref)[0]), h, remat)
        return _head(cfg, lm, lm.norm_f(h), mesh), rows


@torch.no_grad()
def forward(cfg: ModelConfig, lm: LM, batch: Dict, mesh=None,
            remat: str = "none", flash: bool = False) -> torch.Tensor:
    """Prefill forward: logits (B, S, vocab) in the compute type, without
    gradients; across the ranks of a DeviceMesh a DTensor placed by
    :func:`place_logits`. With ``flash`` each layer's attention goes
    through the flash kernel where the reference's would (causal config,
    S % 8 == 0). ``remat`` only matters where gradients are taken, so it
    must be ``"none"`` here; training goes through :func:`loss_fn`."""
    check_remat(remat, grad=False)
    if L.ranked(mesh):
        logits, _ = forward_rows(cfg, lm, batch, mesh, flash=flash)
        return place_logits(cfg, logits, mesh, _batch_size(batch))
    return forward_train(cfg, lm, batch, mesh, flash=flash)


def _nll_terms(logits: torch.Tensor, labels: torch.Tensor,
               ignore: int = -100):
    """(sum of the masked negative log-likelihoods, count of the labels
    kept), float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    flat = logits.reshape(-1, logits.shape[-1])
    rows = torch.arange(flat.shape[0], device=flat.device)
    gold = flat[rows, labels.reshape(-1).clamp_min(0).long()]
    nll = lse - gold.reshape(labels.shape)
    mask = (labels != ignore).to(torch.float32)
    return torch.sum(nll * mask), torch.sum(mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -100, mesh=None) -> torch.Tensor:
    """Masked cross entropy in float32; labels == ``ignore`` are excluded.
    The gold logit is picked by indexing, whose backward has a
    deterministic CUDA implementation. With a DeviceMesh, logits and
    labels are this rank's rows and the mean is the global one: the
    numerator and the count are each summed over the data axes
    (``layers.dp_reduce``) before the division."""
    num, cnt = _nll_terms(logits, labels, ignore)
    num, cnt = L.dp_reduce(num, mesh), L.dp_reduce(cnt, mesh)
    return num / torch.clamp_min(cnt, 1.0)


class _VocabNLL(torch.autograd.Function):
    """Each row's negative log-likelihood from the rank's block of logits
    (columns ``lo`` on; those at ``vocab`` and beyond are padding), the
    max, the sum of exponentials and the gold logit all-reduced over
    ``group``, in float32 of the block only. The backward recomputes the
    block's softmax from the saved compute-type logits and ``lse``."""

    @staticmethod
    def _block(logits, lo, vocab):
        x = logits.to(torch.float32)
        cols = lo + torch.arange(x.shape[-1], device=x.device)
        return x.masked_fill(cols >= vocab, float("-inf")) \
            if lo + x.shape[-1] > vocab else x

    @staticmethod
    def forward(ctx, logits, labels, lo, vocab, group):
        import torch.distributed as dist
        p = logits.shape[-1]
        x = _VocabNLL._block(logits, lo, vocab)
        m = torch.amax(x, dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = torch.sum(torch.exp(x - m[..., None]), dim=-1)
        dist.all_reduce(s, group=group)
        lse = m + torch.log(s)
        # the gold logit from the rank whose block holds the label's
        # column, 0 elsewhere (a label of -100 is in no block)
        ids = labels.reshape(-1).long() - lo
        inside = (ids >= 0) & (ids < p)
        ids = ids.clamp(0, p - 1)
        rows = torch.arange(ids.shape[0], device=x.device)
        gold = torch.where(inside, x.reshape(-1, p)[rows, ids], 0.0)
        dist.all_reduce(gold, group=group)
        ctx.save_for_backward(logits, lse, ids, inside)
        ctx.lo, ctx.vocab = lo, vocab
        return lse - gold.reshape(lse.shape)

    @staticmethod
    def backward(ctx, g):
        logits, lse, ids, inside = ctx.saved_tensors
        p = logits.shape[-1]
        x = _VocabNLL._block(logits, ctx.lo, ctx.vocab)
        grad = torch.exp(x - lse[..., None]) * g[..., None]
        flat = grad.view(-1, p)
        rows = torch.arange(ids.shape[0], device=flat.device)
        flat[rows, ids] = flat[rows, ids] - torch.where(
            inside, g.reshape(-1), 0.0)
        return grad.to(logits.dtype), None, None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       vocab: int, mesh):
    """:func:`_nll_terms` of logits whose vocabulary is split over "model":
    ``logits`` (B_loc, S, padded_vocab / tp) is this rank's block of the
    padded vocabulary's columns in rank order (:func:`_head`), ``labels``
    (B_loc, S) its rows'.
    The log-sum-exp and the gold logit are reduced over "model" (Megatron's
    vocab-parallel cross entropy), so no rank holds the whole
    vocabulary's logits; the padded columns enter neither, and labels of
    -100 are left out. Returns (the masked sum, the count), float32, the
    same on every rank of "model"."""
    lo = L._tp(mesh)[1] * logits.shape[-1]
    nll = _VocabNLL.apply(logits, labels, lo, vocab,
                          mesh.get_group("model"))
    mask = (labels != -100).to(torch.float32)
    return torch.sum(nll * mask), torch.sum(mask)


def ranked_loss(cfg: ModelConfig, logits: torch.Tensor, rows: slice,
                batch: Dict, mesh) -> torch.Tensor:
    """The loss across the ranks of a DeviceMesh from this rank's rows'
    ``logits`` (a family's ``forward_rows``): the global
    masked mean of the cross entropy, vocab-parallel where the head is
    split (:func:`vocab_parallel_nll`), :func:`cross_entropy` where it is
    whole. The DP degree must divide the batch: ranks that held the same
    rows would count their gradients once each."""
    from ..launch.mesh import mesh_shape
    dp = [n for a, n in mesh_shape(mesh).items() if a in ("pod", "data")]
    if rows == slice(None) and any(n > 1 for n in dp):
        raise ValueError(f"a batch of {_batch_size(batch)} rows does not "
                         f"split over data axes of sizes {dp}")
    labels = L.local_rows(batch["labels"], rows)
    if not _vocab_split(cfg, logits, mesh):
        return cross_entropy(logits, labels, mesh=mesh)
    num, cnt = vocab_parallel_nll(logits, labels, cfg.vocab_size, mesh)
    num, cnt = L.dp_reduce(num, mesh), L.dp_reduce(cnt, mesh)
    return num / torch.clamp_min(cnt, 1.0)


def loss_fn(cfg: ModelConfig, lm: LM, batch: Dict, mesh=None,
            remat: str = "none") -> torch.Tensor:
    """Mean cross entropy of ``batch``'s logits against its labels (those
    of -100 left out) with plain attention, as the reference's (the flash
    kernel has no backward). Across the ranks of a DeviceMesh each rank
    takes its rows and the mean is global (:func:`ranked_loss`)."""
    if L.ranked(mesh):
        logits, rows = forward_rows(cfg, lm, batch, mesh, remat)
        return ranked_loss(cfg, logits, rows, batch, mesh)
    logits = forward_train(cfg, lm, batch, mesh, remat=remat)
    return cross_entropy(logits, batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """(cache, axes), zeros in the compute type: k/v (n_layers, B, max_len,
    KV, hd) for GQA; for MLA the latent c_kv (n_layers, B, max_len, r) and
    k_rope (n_layers, B, max_len, qk_rope)."""
    # one layer's cache on the meta device gives shapes and types only
    one_init = MLA.mla_cache_init if cfg.use_mla else L.attention_cache_init
    one, one_axes = one_init(cfg, batch, max_len, device="meta")
    cache = {name: torch.zeros((cfg.n_layers,) + t.shape, dtype=t.dtype,
                               device=device) for name, t in one.items()}
    axes = {name: ("layers",) + ax for name, ax in one_axes.items()}
    return cache, axes


@torch.no_grad()
def decode_step(cfg: ModelConfig, lm: LM, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos, mesh=None):
    """One decode step. tokens: (B, 1) int; pos: int — the current cache
    length. Writes the new keys and values (for MLA the latent and the
    RoPE key) into ``cache`` in place and returns (logits (B, 1, vocab),
    cache). The audio family is an encoder and raises ValueError; a vlm
    step embeds text and turns all three M-RoPE streams by ``pos``.
    Across the ranks of a DeviceMesh each rank steps its rows with
    tensor-parallel layers, writes their caches, and returns the logits
    placed by :func:`place_logits` (the rows whole where the batch does
    not split over the data axes, as for a cache whose positions do)."""
    if cfg.family == "audio":
        raise ValueError("encoder-only architecture has no decode step")
    ranked = L.ranked(mesh)
    pos = int(pos)
    B = tokens.shape[0]
    rows = L.batch_rows(B, mesh)
    seq = L.seq_split(next(iter(cache.values())), 2)
    if seq is not None and cfg.use_mla:
        raise NotImplementedError("latent attention over a cache whose "
                                  "positions are split across ranks")
    with L.tp_weights(lm, mesh, skip=("layers",)):
        h = embed_tokens(cfg, lm.embed, L.local_rows(tokens, rows), mesh)
        ref = L.rows_of(h, mesh, B) if ranked else None
        positions = torch.full((h.shape[0], 1), pos, dtype=torch.int32,
                               device=h.device)
        mrope = (positions[None].expand(3, h.shape[0], 1)
                 if cfg.mrope_sections else None)
        for i, lp in enumerate(lm.layers):
            layer_cache = {name: L.local_rows(c, rows, 1)[i]
                           for name, c in cache.items()}
            with L.tp_weights(lp, mesh):
                h, _ = _layer_apply(cfg, lp, h, positions, mesh,
                                    cache=layer_cache, cache_index=pos,
                                    mrope=mrope, ref=ref, cache_seq=seq)
        logits = _head(cfg, lm, lm.norm_f(h), mesh)
    if ranked:
        logits = place_logits(cfg, logits, mesh, B)
    return logits, cache
