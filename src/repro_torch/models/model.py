"""Top-level model: seeded init, full forward, slot decode, caches.

The port of ``repro/models/model.py`` for stacks of ``attn``, ``sliding``,
``rglru`` and ``ssd`` blocks (qwen3, gemma3, recurrentgemma, mamba2).
Parameters live in an ``nn.Module`` on an explicit device. The decode cache
is a dict of tensors updated in place by :meth:`Model.decode_step`, one
pair of leaves per attention kind, so a stack may hold both:

- ``k``/``v`` ``(full layers, batch, max_len, kv_heads, head_dim)`` for the
  ``attn`` layers, and ``k_ring``/``v_ring`` ``(sliding layers, batch,
  min(window, max_len), kv_heads, head_dim)`` for the ``sliding`` layers'
  rings, in the model dtype;
- the recurrent layers' state in fp32, ``h`` ``(batch, rglru layers,
  lru_width)`` or ``ssm`` ``(batch, ssd layers, heads, head_dim,
  state_dim)``, and their last ``width - 1`` convolution inputs ``conv``
  ``(batch, recurrent layers, width - 1, channels)`` in the model dtype. The
  recurrent state is slot-major, so one probe launch over
  ``state.view(batch, -1)`` gives every slot's state word over all its
  layers.

Layer ``l`` reads row ``cache_index[l]`` of its leaves: its index among the
layers that share them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn as nn

from ..configs.base import ModelConfig
from .attention import cache_write_index, ring_write_index
from .layers import (_rounded, apply_norm, dense_init, embed_lookup,
                     embed_tokens, rope_tables, softmax_cross_entropy, unembed)
from .rglru import CONV_WIDTH
from .ssm import conv_dim
from .transformer import (ATTN_KINDS, RECURRENT_STATE, Block,
                          apply_block_decode, apply_block_train,
                          apply_block_verify, check_block_kind)


class CacheLeaf(NamedTuple):
    slot_axis: int      # indexes the batch row (serving slot)
    layer_axis: int     # indexes the layer, among the layers of its kind


# the layout of every decode cache tensor, read by the cache reset and
# insert, the weight bridge and the serve engine's fault injection
CACHE_LAYOUT = {"k": CacheLeaf(1, 0), "v": CacheLeaf(1, 0),
                "k_ring": CacheLeaf(1, 0), "v_ring": CacheLeaf(1, 0),
                "h": CacheLeaf(0, 1), "ssm": CacheLeaf(0, 1),
                "conv": CacheLeaf(0, 1)}

# each attention kind's K and V leaves
KV_LEAVES = {"attn": ("k", "v"), "sliding": ("k_ring", "v_ring")}
# each block kind's cache leaves, port name -> the JAX layer cache's name
BLOCK_LEAVES = {**{b: {k: "k", v: "v"} for b, (k, v) in KV_LEAVES.items()},
                "rglru": {"h": "h", "conv": "conv"},
                "ssd": {"ssm": "ssm", "conv": "conv"}}


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
        rec_kinds = {b for b in cfg.pattern_layers if b in RECURRENT_STATE}
        if len(rec_kinds) > 1:
            raise NotImplementedError(
                "two recurrent block kinds in one stack (two conv widths) "
                "is not ported: ROADMAP Queue 1, item 14")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "untied unembedding is not ported yet: ROADMAP Queue 1, item "
                "14 (remaining architectures)")
        pin_matmul_precision()
        self.cfg = cfg
        # the recurrent layers' state leaf, "h" (rglru), "ssm" (ssd) or None:
        # what the state probe reads and a state fault poisons (never
        # "conv", as in the JAX package)
        self.state_leaf = RECURRENT_STATE.get(next(iter(rec_kinds), None))
        self.attn_layers = [l for l, b in enumerate(cfg.pattern_layers)
                            if b in ATTN_KINDS]
        self.recurrent_layers = [l for l, b in enumerate(cfg.pattern_layers)
                                 if b in RECURRENT_STATE]
        # layer l's decode cache: row cache_index[l] of its kind's leaves
        # (BLOCK_LEAVES), counted among the layers that share them
        self.cache_index = [
            sum(BLOCK_LEAVES[b2] == BLOCK_LEAVES[b]
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
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, device=self.device, dtype=torch.float32),
            requires_grad=False)
        self.tie_unembed()

    def tie_unembed(self) -> None:
        """(Re)make the fp32 copy of the tied embedding the unembedding reads.
        In bf16 it costs ``vocab * d_model * 4`` bytes once (1.24 GB at full
        qwen3 width) instead of that cast on every step; in fp32 it is the
        embedding itself."""
        self.embed_f32 = (self.embed.detach() if self.dtype == torch.float32
                          else self.embed.detach().float())

    # ------------------------------------------------------------------ forward
    def forward(self, tokens: torch.Tensor, labels: Optional[torch.Tensor] = None,
                loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence causal forward: tokens (B, S) → fp32 logits (B, S, V).

        With ``labels`` (B, S), the training forward instead: the mean
        next-token cross-entropy (over ``loss_mask``'s tokens, if given),
        a differentiable function of the parameters. It reads the embedding
        through :class:`~repro_torch.models.layers.EmbedLookup` (an invalid
        id gives a NaN row, as the JAX package's ``jnp.take``) and unembeds
        from the live ``embed`` cast to fp32 — not from ``embed_f32``, the
        serving copy made once and detached — so the tied embedding gets
        both gradients. :meth:`loss` calls it on a train state's params."""
        cfg = self.cfg
        train = labels is not None
        x = self._embed(tokens, train=train)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device,
                                 dtype=torch.int32).expand(B, S)
        rope = self._rope(positions)
        for blk in self.blocks:
            x = apply_block_train(blk, x, rope, cfg)
        x = apply_norm(self.final_norm, x, cfg.norm)
        if not train:
            return unembed(x, self.embed_f32, softcap=cfg.logit_softcap)
        logits = unembed(x, self.embed.float(), softcap=cfg.logit_softcap)
        return softmax_cross_entropy(logits, labels, loss_mask)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """The training loss of ``batch`` (``tokens``, ``labels``, optional
        ``loss_mask``) under ``params``, a dict of every parameter by its
        ``named_parameters`` name (a train state's ``"params"``): the
        forward runs on those tensors through ``torch.func.functional_call``,
        so gradients reach them and this model's own weights are neither
        read nor touched (its parameters never require a gradient, and may
        lie on the ``meta`` device)."""
        return torch.func.functional_call(
            self, params, (batch["tokens"],),
            {"labels": batch["labels"], "loss_mask": batch.get("loss_mask")},
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
        n = len(self.recurrent_layers)
        if self.state_leaf == "h":
            w = cfg.resolved_lru_width
            cache["h"] = zeros(batch, n, w, dtype=torch.float32)
            cache["conv"] = zeros(batch, n, CONV_WIDTH - 1, w)
        elif self.state_leaf == "ssm":
            cache["ssm"] = zeros(batch, n, cfg.ssm_nheads, cfg.ssm_head_dim,
                                 cfg.ssm_state_dim, dtype=torch.float32)
            cache["conv"] = zeros(batch, n, cfg.ssm_conv_width - 1,
                                  conv_dim(cfg))
        return cache

    def kv_capacity(self, kind: str, max_len: int) -> int:
        """Entries of a layer's K/V cache: ``max_len`` for a full layer,
        ``min(window, max_len)`` for a sliding layer's ring."""
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
        and the unembedding (the speculative draft's shallow exit).
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
        for blk, j in zip(self.blocks[:layers], self.cache_index[:layers]):
            if blk.btype in RECURRENT_STATE:
                state = (cache[self.state_leaf][:, j], cache["conv"][:, j])
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
        x = apply_norm(self.final_norm, x, self.cfg.norm)
        return unembed(x, self.embed_f32, softcap=self.cfg.logit_softcap)

    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        return rope_tables(positions, head_dim=cfg.resolved_head_dim,
                           theta=cfg.rope_theta, style=cfg.rope_style)

    def _embed(self, tokens: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        if train:
            # the scale rounded to the model dtype as a Python number: the
            # same product as the serving path's 0-d tensor, with no
            # host-to-device copy (a sync) inside the train step
            x = embed_lookup(self.embed, tokens, self.dtype)
            scale = self.cfg.embed_scale
            return x * _rounded(scale, self.dtype) if scale != 1.0 else x
        x = embed_tokens(self.embed, tokens, self.dtype)
        if self.cfg.embed_scale != 1.0:
            x = x * torch.tensor(self.cfg.embed_scale, dtype=self.dtype,
                                 device=x.device)
        return x
