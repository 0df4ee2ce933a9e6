"""Top-level model: seeded init, full forward, slot decode, caches.

The port of ``repro/models/model.py`` for stacks of ``attn``, ``sliding``,
``cross``, ``rglru`` and ``ssd`` blocks with MLPs or MoE FFNs, rms or layer
norms, tied or untied unembeddings (qwen3, qwen3-moe, gemma3,
recurrentgemma, mamba2, starcoder2, chatglm3, phi3.5-moe, llama-3.2-vision,
whose every fifth layer cross-attends image tokens, and hubert-xlarge, a
bidirectional encoder). The modality frontends are stubs, as in the JAX
package: :meth:`Model.forward` takes precomputed frame embeddings
(``inputs_embeds``) or image embeddings (``img_embeds``).
Parameters live in an ``nn.Module`` on an explicit device. The decode cache
is a dict of tensors updated in place by :meth:`Model.decode_step`, one
pair of leaves per attention kind, so a stack may hold several:

- ``k``/``v`` ``(full layers, batch, max_len, kv_heads, head_dim)`` for the
  ``attn`` layers, ``k_ring``/``v_ring`` ``(sliding layers, batch,
  min(window, max_len), kv_heads, head_dim)`` for the ``sliding`` layers'
  rings, and ``k_cross``/``v_cross`` ``(cross layers, batch, img_tokens,
  kv_heads, head_dim)`` for the ``cross`` layers' image K/V, which decode
  reads and never writes (zeros in a fresh cache, as the JAX package's:
  its serving never fills them), all in the model dtype;
- the recurrent layers' state in fp32, ``h`` ``(batch, rglru layers,
  lru_width)`` and/or ``ssm`` ``(batch, ssd layers, heads, head_dim,
  state_dim)``, and their last ``width - 1`` convolution inputs ``conv``
  ``(batch, recurrent layers, width - 1, channels)`` in the model dtype (in
  a stack of both kinds, whose convolutions differ in width and channels,
  ``conv`` is the RG-LRU layers' and ``conv_ssd`` the SSD layers'). The
  recurrent state is slot-major, so one probe launch over
  ``state.view(batch, -1)`` gives every slot's state word over all the
  layers of its kind.

Layer ``l`` reads row ``cache_index[l]`` of its leaves: its index among the
layers that share them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn as nn

from ..configs.base import ModelConfig
from .attention import cache_write_index, ring_write_index
from .layers import (_rounded, apply_norm, chunked_cross_entropy, dense_init,
                     embed_lookup, embed_tokens, rope_tables,
                     softmax_cross_entropy, unembed)
from .rglru import CONV_WIDTH
from .ssm import conv_dim
from .transformer import (ATTN_KINDS, RECURRENT_STATE, Block,
                          apply_block_decode, apply_block_train,
                          apply_block_verify, check_block_kind, norm_params)


class CacheLeaf(NamedTuple):
    slot_axis: int      # indexes the batch row (serving slot)
    layer_axis: int     # indexes the layer, among the layers of its kind


# the layout of every decode cache tensor, read by the cache reset and
# insert, the weight bridge and the serve engine's fault injection
CACHE_LAYOUT = {"k": CacheLeaf(1, 0), "v": CacheLeaf(1, 0),
                "k_ring": CacheLeaf(1, 0), "v_ring": CacheLeaf(1, 0),
                "k_cross": CacheLeaf(1, 0), "v_cross": CacheLeaf(1, 0),
                "h": CacheLeaf(0, 1), "ssm": CacheLeaf(0, 1),
                "conv": CacheLeaf(0, 1), "conv_ssd": CacheLeaf(0, 1)}

# each attention kind's K and V leaves
KV_LEAVES = {"attn": ("k", "v"), "sliding": ("k_ring", "v_ring"),
             "cross": ("k_cross", "v_cross")}
# each block kind's cache leaves, port name -> the JAX layer cache's name
# (a recurrent kind's state leaf first, then its convolution's)
BLOCK_LEAVES = {**{b: {k: "k", v: "v"} for b, (k, v) in KV_LEAVES.items()},
                "rglru": {"h": "h", "conv": "conv"},
                "ssd": {"ssm": "ssm", "conv": "conv"}}


def block_leaves(cfg: ModelConfig) -> dict:
    """:data:`BLOCK_LEAVES` for ``cfg``'s stack: in a stack of both
    recurrent kinds the SSD layers' convolution inputs are ``conv_ssd``
    (their width and channels differ from the RG-LRU layers')."""
    if not {"rglru", "ssd"} <= set(cfg.pattern_layers):
        return BLOCK_LEAVES
    return {**BLOCK_LEAVES, "ssd": {"ssm": "ssm", "conv_ssd": "conv"}}


def slot_layer_view(cache: dict, name: str) -> torch.Tensor:
    """``cache[name]`` viewed with the slot axis first and the layer axis
    second; writes through the view land in the cache."""
    leaf = CACHE_LAYOUT[name]
    return cache[name].movedim((leaf.slot_axis, leaf.layer_axis), (0, 1))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when that is CUDA and there is none — the port never
    drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    return dev


def pin_matmul_precision() -> None:
    """fp32 products in full fp32 on the card: TF32 off for cuBLAS and cuDNN.
    Every model build calls this — the one place the port sets it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def reset_cache_slot(cache: dict, slot: int) -> None:
    """Zero batch row ``slot`` of every cache tensor, in place — the fresh
    cache of a new sequence (the JAX package's fresh template is all
    zeros)."""
    for name in cache:
        slot_layer_view(cache, name)[slot].zero_()


def insert_cache_slot(full: dict, one: dict, slot: int, row: int) -> None:
    """Copy batch row ``row`` of every tensor of the rebuilt cache ``one``
    into batch row ``slot`` of the live caches ``full``, in place, queued on
    the device (the JAX replica's ``_insert``). The whole row is copied,
    not only the rebuilt prefix: a window already queued may have written
    the slot's row past the rebuilt sequence, and a NaN left there may
    reach the attention output through a masked key's zero weight."""
    if one.keys() != full.keys():
        raise ValueError(f"cache leaves {sorted(one)} != {sorted(full)}")
    for name in full:
        slot_layer_view(full, name)[slot].copy_(slot_layer_view(one, name)[row])


class Model(nn.Module):
    """Decoder bound to a config, with its weights on ``device``.

    ``seed`` draws the weights with a ``torch.Generator`` on that device from
    the same distributions as the JAX package's init; ``seed=None`` leaves
    them uninitialised for the weight bridge
    (:func:`repro_torch.weights.params_from_jax`) to fill.
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        for b in cfg.pattern_layers:
            check_block_kind(b)
        pin_matmul_precision()
        self.cfg = cfg
        # the recurrent layers' state leaves, "h" (rglru) and/or "ssm"
        # (ssd), in RECURRENT_STATE's order: what the state probe reads and
        # a state fault poisons (never a convolution's, as in the JAX
        # package)
        self.state_leaves = tuple(leaf for b, leaf in RECURRENT_STATE.items()
                                  if b in cfg.pattern_layers)
        self.attn_layers = [l for l, b in enumerate(cfg.pattern_layers)
                            if b in ATTN_KINDS]
        self.recurrent_layers = [l for l, b in enumerate(cfg.pattern_layers)
                                 if b in RECURRENT_STATE]
        # layer l's decode cache: row cache_index[l] of its kind's leaves
        # (block_leaves), counted among the layers that share them
        self.block_leaves = block_leaves(cfg)
        self.cache_index = [
            sum(self.block_leaves[b2] == self.block_leaves[b]
                for b2 in cfg.pattern_layers[:l])
            for l, b in enumerate(cfg.pattern_layers)]
        self.device = resolve_device(device)
        self.dtype = model_dtype(cfg)
        gen = None
        if seed is not None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        shape = (cfg.vocab_size, cfg.d_model)
        emb = (torch.empty(shape, device=self.device, dtype=self.dtype)
               if gen is None else
               dense_init(shape, generator=gen, device=self.device,
                          dtype=self.dtype, scale=1.0))
        self.embed = nn.Parameter(emb, requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, b, device=self.device, dtype=self.dtype, generator=gen)
            for b in cfg.pattern_layers)
        self.final_norm, self.final_norm_bias = norm_params(cfg, self.device)
        # the untied unembedding kernel (d, V), drawn last so the tied
        # models' draws stay as they were
        self.unembed = None
        if not cfg.tie_embeddings:
            shape = (cfg.d_model, cfg.vocab_size)
            un = (torch.empty(shape, device=self.device, dtype=self.dtype)
                  if gen is None else
                  dense_init(shape, generator=gen, device=self.device,
                             dtype=self.dtype))
            self.unembed = nn.Parameter(un, requires_grad=False)
        self.tie_unembed()

    def unembed_weight(self) -> torch.Tensor:
        """The live unembedding matrix (d, V) in the model dtype: the tied
        embedding's transpose or the untied kernel."""
        return self.embed.t() if self.unembed is None else self.unembed

    def tie_unembed(self) -> None:
        """(Re)make ``unembed_f32``, the fp32 copy (d, V) of the unembedding
        matrix that serving reads: the tied embedding's transpose or the
        untied kernel. In bf16 it costs ``vocab * d_model * 4`` bytes once
        (1.24 GB at full qwen3 width) instead of that cast on every step; in
        fp32 it is the weight itself."""
        w = self.unembed_weight().detach()
        self.unembed_f32 = w if self.dtype == torch.float32 else w.float()

    # ------------------------------------------------------------------ forward
    def forward(self, tokens: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                loss_mask: Optional[torch.Tensor] = None, *,
                inputs_embeds: Optional[torch.Tensor] = None,
                img_embeds: Optional[torch.Tensor] = None,
                with_aux: bool = False, ce_chunk: int = 0):
        """Full-sequence forward: tokens (B, S) → fp32 logits (B, S, V);
        causal, or bidirectional for an encoder (``cfg.causal`` False).

        ``inputs_embeds (B, S, d)`` replaces the token embedding (the audio
        frontend's frame embeddings, cast to the model dtype, then scaled by
        ``embed_scale`` as a token embedding would be); ``img_embeds (B, T,
        d)``, cast to the model dtype, are what every ``cross`` layer
        attends. Without them a ``cross`` layer runs as causal
        self-attention with the rotary, gated, as the JAX package's does.

        With ``labels`` (B, S), the training forward instead: the mean
        next-token cross-entropy (over ``loss_mask``'s tokens, if given),
        a differentiable function of the parameters. It reads the embedding
        through :class:`~repro_torch.models.layers.EmbedLookup` (an invalid
        id gives a NaN row, as the JAX package's ``jnp.take``) and unembeds
        from the live weight cast to fp32 — not from ``unembed_f32``, the
        serving copy made once and detached — so the unembedding (and a
        tied embedding through both uses) gets its gradient. :meth:`loss`
        calls it on a train state's params. With ``ce_chunk``, that loss is
        :func:`~repro_torch.models.layers.chunked_cross_entropy` over
        sequence chunks of ``ce_chunk`` positions (the JAX package's
        ``loss(ce_chunk=...)``): no (B, S, V) logits, and ``loss_mask`` not
        read, as there.

        ``with_aux=True`` returns ``(logits or loss, {"dropped_fraction"})``:
        the MoE layers' dropped fractions summed and divided by the layers
        with an FFN (every layer but ``ssd``), as the JAX package's
        backbone gives it; a 0-d fp32 tensor, 0 for a model without MoE."""
        cfg = self.cfg
        train = labels is not None
        x = self._embed(tokens, train=train, inputs_embeds=inputs_embeds)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device,
                                 dtype=torch.int32).expand(B, S)
        rope = self._rope(positions)
        if img_embeds is not None:
            img_embeds = img_embeds.to(self.dtype)
        drops = []
        for blk in self.blocks:
            x, drop = apply_block_train(blk, x, rope, cfg, img_embeds)
            if drop is not None:
                drops.append(drop)
        x = apply_norm(self.final_norm, x, cfg.norm,
                       bias=self.final_norm_bias)
        if not train:
            out = unembed(x, self.unembed_f32, softcap=cfg.logit_softcap)
        elif ce_chunk:
            # the fp32 weight is cast once, here, inside the functional call:
            # each chunk's recompute in the backward reads this tensor
            w = self.unembed_weight().float()
            out = chunked_cross_entropy(
                x, labels, lambda xc: unembed(xc, w, softcap=cfg.logit_softcap),
                ce_chunk)
        else:
            logits = unembed(x, self.unembed_weight().float(),
                             softcap=cfg.logit_softcap)
            out = softmax_cross_entropy(logits, labels, loss_mask)
        if not with_aux:
            return out
        n_ffn = max(sum(b != "ssd" for b in cfg.pattern_layers), 1)
        total = (torch.stack(drops).sum() if drops else
                 torch.zeros((), device=x.device, dtype=torch.float32))
        return out, {"dropped_fraction": total / n_ffn}

    def loss(self, params: dict, batch: dict, *, ce_chunk: int = 0):
        """``(loss, aux)``: the training loss of ``batch`` (``labels``, and
        ``tokens`` or the frame embeddings ``inputs_embeds``, optional
        ``img_embeds`` and ``loss_mask``) under ``params``, a dict of every
        parameter by its ``named_parameters`` name (a train state's
        ``"params"``), and :meth:`forward`'s aux, as the JAX package's
        ``loss`` returns them. The forward runs on those tensors through
        ``torch.func.functional_call``, so gradients reach them and this
        model's own weights are neither read nor touched (its parameters
        never require a gradient, and may lie on the ``meta`` device). The
        embeddings are inputs: no gradient reaches them. ``ce_chunk`` chunks
        the loss over the sequence, as :meth:`forward` says."""
        return torch.func.functional_call(
            self, params, (batch.get("tokens"),),
            {"labels": batch["labels"], "loss_mask": batch.get("loss_mask"),
             "inputs_embeds": batch.get("inputs_embeds"),
             "img_embeds": batch.get("img_embeds"), "with_aux": True,
             "ce_chunk": ce_chunk},
            strict=True)

    # ------------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        zeros = lambda *shape, dtype=self.dtype: torch.zeros(  # noqa: E731
            shape, device=self.device, dtype=dtype)
        cache = {}
        for kind in ATTN_KINDS:
            n = cfg.pattern_layers.count(kind)
            if n:
                shape = (n, batch, self.kv_capacity(kind, max_len),
                         cfg.num_kv_heads, cfg.resolved_head_dim)
                k, v = KV_LEAVES[kind]
                cache[k], cache[v] = zeros(*shape), zeros(*shape)
        if "h" in self.state_leaves:
            n, w = cfg.pattern_layers.count("rglru"), cfg.resolved_lru_width
            cache["h"] = zeros(batch, n, w, dtype=torch.float32)
            cache["conv"] = zeros(batch, n, CONV_WIDTH - 1, w)
        if "ssm" in self.state_leaves:
            n = cfg.pattern_layers.count("ssd")
            _, conv = self.block_leaves["ssd"]
            cache["ssm"] = zeros(batch, n, cfg.ssm_nheads, cfg.ssm_head_dim,
                                 cfg.ssm_state_dim, dtype=torch.float32)
            cache[conv] = zeros(batch, n, cfg.ssm_conv_width - 1,
                                conv_dim(cfg))
        return cache

    def kv_capacity(self, kind: str, max_len: int) -> int:
        """Entries of a layer's K/V cache: ``max_len`` for a full layer,
        ``min(window, max_len)`` for a sliding layer's ring, ``img_tokens``
        for a cross layer."""
        if kind == "cross":
            return self.cfg.img_tokens
        return (min(self.cfg.sliding_window, max_len) if kind == "sliding"
                else max_len)

    def decode_step(self, token: torch.Tensor, cache: dict,
                    pos: Union[int, torch.Tensor], *,
                    layers: Optional[int] = None) -> torch.Tensor:
        """One new token per batch row against ``cache`` (updated in place).

        token (B, 1) int; pos an int (every row at that position, as the JAX
        package's scalar ``pos``) or an int32 (B,) tensor on the model's
        device (per-slot positions). Returns fp32 logits (B, 1, V).
        ``layers`` runs the first that many layers only, then the final norm
        and the unembedding (the speculative draft's shallow exit). A
        ``cross`` layer reads its image K/V (``k_cross``/``v_cross``) and
        writes nothing. Every self-attention layer decodes causally, an
        encoder's too, as the JAX package's decode does.
        """
        cfg = self.cfg
        pos = self._positions(pos, token.shape[0])
        x = self._embed(token)
        # every attention layer rotates at the same positions, and every
        # layer of one kind writes its cache at the same index
        rope = self._rope(pos[:, None])
        write_idx = {}
        if "k" in cache:
            write_idx["attn"] = cache_write_index(pos, cache["k"].shape[2])
        if "k_ring" in cache:
            write_idx["sliding"] = ring_write_index(pos, cache["k_ring"].shape[2])
        if "k_cross" in cache:          # the cross launches' q_offset
            zeros = torch.zeros_like(pos)
        for blk, j in zip(self.blocks[:layers], self.cache_index[:layers]):
            if blk.btype in RECURRENT_STATE:
                rec, conv = self.block_leaves[blk.btype]
                state = (cache[rec][:, j], cache[conv][:, j])
            elif blk.btype == "cross":
                state = (cache["k_cross"][j], cache["v_cross"][j], zeros)
            else:
                k, v = KV_LEAVES[blk.btype]
                state = (cache[k][j], cache[v][j], write_idx[blk.btype])
            x = apply_block_decode(blk, x, state, pos, rope, cfg)
        return self._head(x)

    # -------------------------------------------------------------- speculate
    def supports_speculation(self) -> bool:
        """Speculative decode windows need every cache write to be
        positional and idempotent, so that a rejected draft's entries are
        overwritten before anything reads them: pure full-attention stacks
        only (rings and recurrent states advance destructively), and no MoE
        (the router couples the tokens of a verify batch)."""
        return (all(b == "attn" for b in self.cfg.pattern_layers)
                and not self.cfg.is_moe)

    def verify_step(self, tokens: torch.Tensor, cache: dict,
                    pos: Union[int, torch.Tensor]) -> torch.Tensor:
        """T new tokens per batch row ("speculative verify") against
        ``cache`` (updated in place): tokens (B, T) int at positions ``pos ..
        pos + T - 1``, pos an int or an int32 (B,) device tensor. Returns fp32
        logits (B, T, V).

        Row t is bit-equal to :meth:`decode_step` at ``pos + t`` after the
        rows before it — its logits and the K/V entries it leaves: every
        product, norm and elementwise op of a row runs at the decode step's
        shape (B rows), and the T rows meet only in each layer's one flash
        launch (:func:`~repro_torch.models.attention.attention_verify`)."""
        cfg = self.cfg
        if not self.supports_speculation():
            raise ValueError(f"{cfg.name}: the speculative verify takes pure "
                             "full-attention stacks only")
        T = tokens.shape[1]
        pos = self._positions(pos, tokens.shape[0])
        xs = [self._embed(tokens[:, t:t + 1]) for t in range(T)]
        ropes = [self._rope((pos + t)[:, None]) for t in range(T)]
        for blk, j in zip(self.blocks, self.cache_index):
            xs = apply_block_verify(blk, xs, (cache["k"][j], cache["v"][j]),
                                    pos, ropes, cfg)
        return torch.cat([self._head(x) for x in xs], dim=1)

    def draft_chain(self, token: torch.Tensor, cache: dict,
                    pos: Union[int, torch.Tensor], *, draft_layers: int,
                    draft_len: int, override: Optional[torch.Tensor] = None,
                    n_forced: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``draft_len`` greedy proposals per batch row from the first
        ``draft_layers`` layers, the final norm and the unembedding (the
        shallow-exit self-draft), each a :meth:`decode_step` over those
        layers at ``pos + d`` writing their caches in place (the verify
        rewrites those entries).

        token (B, 1) int at ``pos``; returns proposals (B, draft_len) int32.
        ``override (B, draft_len)`` with ``n_forced (B,)`` feeds a row's
        pending prompt through the chain: proposal ``d`` is replaced by
        ``override[:, d]`` while ``d + 1 < n_forced`` (the speculative
        window's prompt feed at verify width)."""
        if not 0 < draft_layers <= self.cfg.num_layers:
            raise ValueError(f"draft layers must be in [1, {self.cfg.num_layers}]"
                             f", got {draft_layers}")
        pos = self._positions(pos, token.shape[0])
        tok, out = token, []
        for d in range(draft_len):
            logits = self.decode_step(tok, cache, pos + d, layers=draft_layers)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            if override is not None:
                tok = torch.where((d + 1 < n_forced)[:, None],
                                  override[:, d:d + 1], tok)
            out.append(tok)
        return torch.cat(out, dim=1)

    def _positions(self, pos: Union[int, torch.Tensor], B: int) -> torch.Tensor:
        """``pos`` as an int32 (B,) tensor on the model's device (an int:
        every row there)."""
        if isinstance(pos, int):
            return torch.full((B,), pos, dtype=torch.int32, device=self.device)
        return pos

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the unembedding: fp32 logits."""
        x = apply_norm(self.final_norm, x, self.cfg.norm,
                       bias=self.final_norm_bias)
        return unembed(x, self.unembed_f32, softcap=self.cfg.logit_softcap)

    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        return rope_tables(positions, head_dim=cfg.resolved_head_dim,
                           theta=cfg.rope_theta, style=cfg.rope_style,
                           fraction=cfg.rope_fraction)

    def _embed(self, tokens: Optional[torch.Tensor], *, train: bool = False,
               inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        # the scale rounded to the model dtype as a Python number: the same
        # product as a 0-d tensor of the model dtype, with no host-to-device
        # copy (a host sync) inside a train or decode step
        if inputs_embeds is not None:
            x = inputs_embeds.to(self.dtype)
        else:
            x = (embed_lookup if train else embed_tokens)(self.embed, tokens,
                                                          self.dtype)
        scale = self.cfg.embed_scale
        return x * _rounded(scale, self.dtype) if scale != 1.0 else x
