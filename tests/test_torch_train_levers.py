"""The train step's ``microbatch`` and ``ce_chunk`` levers against the JAX
package's ``PerfOptions(microbatch=k, ce_chunk=c)``, on smoke configs, from
the same params (cross gates and layer norm biases drawn non-zero) and the
same seeded batch: one step each, compared on the word, the loss, the
gradient norm and the new params.

Both sides compute in fp32 and add the microbatches' ``g / k`` and the
chunks' NLL sums in the same order; they differ in the summation order
inside each op only, so the tolerances are ``test_torch_train``'s (loss
1e-6 relative; ``grad_norm`` and ``lr`` 1e-5; each new leaf within 1e-5 of
its largest value). The state's step is set to 10, so the warmup's
learning rate is non-zero and the new params move, and its second moments
to 1e-4, as a carried state has them non-zero: from zero moments the first
update is ``g / |g|``, which turns the rounding of a gradient near 0 into a
whole learning rate.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.detect import ProbeConfig as JaxProbeConfig
from repro.data import pipeline as jpipe
from repro.launch.steps import PerfOptions
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.train import build_train_setup as jax_build
from repro_torch.configs import smoke_config
from repro_torch.core import faults
from repro_torch.core.detect import ProbeConfig
from repro_torch.core.errors import ErrorCode
from repro_torch.data import pipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.weights import train_state_from_jax, train_state_to_numpy
from test_torch_train import DIVERGENCE, GRAD_TOL, LOSS_RTOL, drawn

torch.set_num_threads(2)

TOTAL, STEP = 60, 10
ARCH = "qwen3-1.7b"
# (microbatch, ce_chunk, batch, seq): the levers apart and together; a
# chunk of 12 over 32 positions pads the third chunk with 4 zero rows; a
# batch of 3 in 2 microbatches leaves its last row out, as the reference
LEVERS = {"mb2": (2, 0, 4, 16), "ce8": (0, 8, 2, 16), "mb2_ce8": (2, 8, 4, 16),
          "ce12_ragged": (0, 12, 2, 32), "mb2_b3": (2, 0, 3, 16)}
# one step per (arch, lever): every stack kind and batch family, each
# lever on at least one of them — MoE (the dropped fraction summed / k),
# RG-LRU with sliding attention, SSD, frame embeddings (no tokens; the
# indivisible batch), image embeddings (each slice keeps its rows' images).
# The recurrentgemma and VLM smoke stacks are cut to one period (3 and 5
# layers) on both sides: each case compiles the reference's step once
CASES = [(ARCH, "mb2_ce8"), (ARCH, "mb2"), (ARCH, "ce12_ragged"),
         (ARCH, "mb2_b3"), ("recurrentgemma-2b", "mb2_ce8"),
         ("mamba2-2.7b", "ce8"), ("qwen3-moe-30b-a3b", "mb2"),
         ("hubert-xlarge", "mb2_b3"), ("llama-3.2-vision-11b", "mb2_ce8")]
LAYERS = {"recurrentgemma-2b": 3, "llama-3.2-vision-11b": 5}


def _cut(cfg):
    return cfg.replace(num_layers=LAYERS.get(cfg.name, cfg.num_layers))


@functools.lru_cache(maxsize=None)
def _setup(arch, batch, seq):
    """The JAX state (gates and biases drawn, at step ``STEP``, first
    moments 0 and second 1e-4) and the pipeline config, for ``batch`` x
    ``seq``."""
    cfg = _cut(jax_smoke_config(arch))
    _, _, state, pipe, opt_cfg = jax_build(cfg, batch_size=batch, seq_len=seq,
                                           total_steps=TOTAL)
    opt = {**state["opt"], "v": jax.tree_util.tree_map(
        lambda v: jnp.full_like(v, 1e-4), state["opt"]["v"])}
    state = {**state, "params": drawn(state["params"]), "opt": opt,
             "step": jnp.int32(STEP)}
    return cfg, state, pipe.cfg, opt_cfg


@functools.lru_cache(maxsize=None)
def _steps(arch, microbatch, ce_chunk, batch, seq):
    jcfg, jstate, pcfg, jopt = _setup(arch, batch, seq)
    div = DIVERGENCE.get(arch, 50.0)
    jstep = jax.jit(jax_make_train_step(
        jcfg, jopt, JaxProbeConfig(loss_divergence_threshold=div),
        perf=PerfOptions(microbatch=microbatch, ce_chunk=ce_chunk)))
    cfg = _cut(smoke_config(arch))
    step = make_train_step(cfg, AdamWConfig(**dataclasses.asdict(jopt)),
                           ProbeConfig(loss_divergence_threshold=div),
                           microbatch=microbatch, ce_chunk=ce_chunk)
    return cfg, step, jstep, jstate, pcfg


def _run(arch, lever, inject=0):
    microbatch, ce_chunk, batch, seq = LEVERS[lever]
    cfg, step, jstep, jstate, pcfg = _steps(arch, microbatch, ce_chunk, batch, seq)
    state = train_state_from_jax(jax.device_get(jstate), cfg, device="cpu")
    new, metrics, word = step(state, pipeline.make_batch(pcfg, 3, "cpu"), inject)
    jbatch = jpipe.make_batch(jpipe.PipelineConfig(**pcfg.__dict__), 3)
    jnew, jm, jword = jstep(jstate, jbatch, jnp.uint32(inject))
    return cfg, (new, metrics, int(word)), (jnew, jm, int(jword))


def _assert_close(cfg, got, want):
    (new, metrics, word), (jnew, jm, jword) = got, want
    assert word == jword == 0
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    for key in ("grad_norm", "lr", "dropped_fraction"):
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]),
                                   rtol=1e-5, atol=1e-7)
    leaves = jax.tree_util.tree_leaves(jax.device_get(jnew))
    mine = jax.tree_util.tree_leaves(train_state_to_numpy(new, cfg))
    assert len(mine) == len(leaves)
    for a, b in zip(mine, leaves):
        b = np.asarray(b)
        assert np.max(np.abs(a - b)) <= GRAD_TOL * max(np.max(np.abs(b)), 1e-30)


@pytest.mark.parametrize("arch,lever", CASES)
def test_levers_match_jax(arch, lever):
    cfg, got, want = _run(arch, lever)
    _assert_close(cfg, got, want)
    if cfg.is_moe:      # the tight smoke capacity drops assignments
        assert got[1]["dropped_fraction"].item() > 0


@pytest.mark.parametrize("inject", [faults.INJ_NAN_LOSS, faults.INJ_NAN_GRAD,
                                    faults.INJ_SPIKE_LOSS, faults.INJ_BAD_DATA,
                                    faults.INJ_STATE_NAN, 0b11111])
def test_injections_under_microbatch_give_the_jax_word(inject):
    """The tokens are corrupted in the whole batch before it is sliced, and
    the loss and gradient injections apply to the sums: the reference's
    word, bit for bit."""
    _, (_, _, word), (_, _, jword) = _run(ARCH, "mb2_ce8", inject)
    assert word == jword
    if inject & faults.INJ_BAD_DATA:
        assert word & ErrorCode.DATA_FAULT
