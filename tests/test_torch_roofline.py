"""The port's shapes, cells, parameter counts, roofline terms and dry run:
the cell table and the analytic counts equal the JAX package's for every
arch; the three terms at the H100's constants; the dispatch counter on a
function whose ops and bytes are known; and one train and one decode cell
counted at full width, cut to one period, their FLOPs held to 6·N·D and
2·N·D plus the attention's products."""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import SMOKE_SHAPE as JAX_SMOKE_SHAPE
from repro.configs import all_cells as jax_all_cells
from repro.configs import cell_skip_reason as jax_cell_skip_reason
from repro.roofline import analysis as jax_analysis
from repro_torch.configs import (ARCHS, SHAPES, SMOKE_SHAPE, all_cells,
                                 cell_skip_reason, get_config)
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis
from repro_torch.roofline.dispatch import (DispatchCount, estimate_hbm_bytes,
                                           op_histogram)


def test_cells_and_shapes_are_the_reference_s():
    assert all_cells() == jax_all_cells()
    assert [dataclasses.astuple(s) for s in SHAPES.values()] == [
        dataclasses.astuple(s) for s in JAX_SHAPES.values()]
    assert dataclasses.astuple(SMOKE_SHAPE) == dataclasses.astuple(JAX_SMOKE_SHAPE)
    for arch in ARCHS:
        for shape in SHAPES:
            assert cell_skip_reason(arch, shape) == jax_cell_skip_reason(arch, shape)


@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_parameter_counts_are_the_reference_s(arch):
    cfg, ref = get_config(arch), JAX_ARCHS[arch]
    assert cfg.params_count() == ref.params_count()
    assert cfg.active_params_count() == ref.active_params_count()
    assert (cfg.subquadratic, cfg.has_global_attention) == (
        ref.subquadratic, ref.has_global_attention)


def test_terms_at_the_h100_constants():
    """The reference's arithmetic with the card's data-sheet figures: a
    step of 989 TFLOP and 1.675 TB is 1 s of compute and 0.5 s of memory."""
    assert (analysis.PEAK_FLOPS_BF16, analysis.HBM_BW, analysis.ICI_LINK_BW) == (
        989e12, 3.35e12, 450e9)
    terms = analysis.RooflineTerms(chips=1, hlo_flops_per_device=989e12,
                                   hlo_bytes_per_device=1.675e12,
                                   collective_bytes_per_device=0.0,
                                   model_flops=494.5e12)
    assert (terms.compute_s, terms.memory_s, terms.collective_s) == (1.0, 0.5, 0.0)
    assert terms.dominant == "compute" and terms.bound_s == 1.0
    assert terms.model_flops_ratio == 0.5 and terms.roofline_fraction == 0.5
    ref = jax_analysis.RooflineTerms(chips=1, hlo_flops_per_device=989e12,
                                     hlo_bytes_per_device=1.675e12,
                                     collective_bytes_per_device=0.0,
                                     model_flops=494.5e12)
    assert set(terms.to_dict()) == set(ref.to_dict())
    assert terms.model_flops_ratio == ref.model_flops_ratio
    shape = SHAPES["train_4k"]
    for arch in ARCHS:
        assert analysis.model_flops_for(get_config(arch), shape) == \
            jax_analysis.model_flops_for(JAX_ARCHS[arch], JAX_SHAPES["train_4k"])


def test_dispatch_counts_ops_bytes_and_the_peak():
    """``(a @ b + 1).t()`` on fake fp32 tensors: one mm (reads 64x32 and
    32x16, writes 64x16), one add (reads and writes 64x16), a view that
    moves nothing; 2·64·32·16 FLOPs; at the peak the arguments, the mm's
    output and the add's output are live."""
    f32 = 4
    with FakeTensorMode():
        a, b = torch.randn(64, 32), torch.randn(32, 16)
        with DispatchCount() as count:
            count.track((a, b))
            ((a @ b) + 1).t()
    assert op_histogram(count) == {"aten.mm": 1, "aten.add": 1, "aten.t": 1}
    hbm = estimate_hbm_bytes(count)
    assert hbm["by_op"] == {"aten.mm": (64 * 32 + 32 * 16 + 64 * 16) * f32,
                            "aten.add": 2 * 64 * 16 * f32, "aten.t": 0}
    assert hbm["total_bytes"] == sum(hbm["by_op"].values())
    assert count.flops == 2 * 64 * 32 * 16
    assert count.peak_bytes == (64 * 32 + 32 * 16 + 2 * 64 * 16) * f32


def test_perf_levers_of_the_dry_run():
    assert dryrun.parse_perf("mb=8,ce=2048") == {"microbatch": 8, "ce_chunk": 2048}
    for spec in ("sp=1", "cacheseq=1", "ep=1"):
        with pytest.raises(ValueError, match="ROADMAP item 11"):
            dryrun.parse_perf(spec)
    with pytest.raises(ValueError, match="not a lever"):
        dryrun.parse_perf("win=8")


def _attention_products(cfg, batch: int, rows: int, keys: int) -> float:
    """The forward's q·k and p·v products over every key, per model."""
    layers = sum(b in ("attn", "sliding", "cross") for b in cfg.pattern_layers)
    return 4.0 * layers * batch * rows * keys * cfg.num_heads * cfg.resolved_head_dim


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dry_run_counts_a_cell_at_full_width(shape, tmp_path):
    """qwen3-1.7b at full width, one layer. Every parameter's matmul is
    counted: 2·N·D a forward (the embedding a gather, tied to the
    unembedding's product), 4·N·D more for a train step's backward. Beside
    them the attention's products: the plain version computes every key's
    score, so the decode counts exactly the forward's over the 32768-entry
    cache; a train step counts the forward's, the backward's recompute and
    its two products, each at most the forward's (a causal backward skips
    the blocks above the diagonal)."""
    cfg = get_config("qwen3-1.7b").replace(num_layers=1)
    sh = SHAPES[shape]
    rec = dryrun.run_cell("qwen3-1.7b", shape, config_override=cfg)
    assert rec["ok"], rec.get("traceback")
    assert (rec["mesh"], rec["chips"]) == ("1xH100", 1)
    model = analysis.model_flops_for(cfg, sh)
    if sh.kind == "decode":
        attn = _attention_products(cfg, sh.global_batch, 1, sh.seq_len)
        assert rec["flops"] == pytest.approx(model + attn, rel=1e-3)
        assert rec["kernels"] == {"kernel.flash_attention": 1,
                                  "kernel.probe_rows": 1}
    else:
        attn = _attention_products(cfg, sh.global_batch, sh.seq_len, sh.seq_len)
        assert model + attn <= rec["flops"] <= (model + 4 * attn) * 1.001
        assert rec["kernels"] == {"kernel.flash_attention": 1,
                                  "kernel.probe_tree": 1}
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_live_bytes"]
    assert rec["fits"] == (mem["peak_live_bytes"] <= 80e9)
    assert rec["roofline"]["model_flops"] == model
