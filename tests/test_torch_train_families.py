"""Training the encoder and the VLM: the port's ``audio`` and ``vlm``
batches, its loss with frame and image embeddings, and its command line,
against the JAX package on the smoke configs (hubert-xlarge: 2 layers,
bidirectional, frame embeddings; llama-3.2-vision-11b: 10 layers, every
fifth a gated ``cross`` layer over 8 image tokens; both float32).

The gradient, train-step, executor and LFLR tests of ``test_torch_train.py``
run on both families too (its ``TRAIN_ARCHS``, gates drawn; there the
encoder's unread token embedding gets zeros and an audio batch's bad-data
injection no DATA bit); here are what only these families have: batches
without tokens or with image embeddings (bit-equal, as the reference draws
them, and carried by a checkpoint and a reshard), the cross layer's
exactly zero gradient at the seeded gates, and the command line. Batches
and zeros must be equal.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import pipeline as jpipe
from repro.launch.train import build_train_setup as jax_build
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import smoke_config
from repro_torch.data import pipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_loss_and_grads
from repro_torch.weights import _flat_from_jax, train_state_from_jax

torch.set_num_threads(2)

B, S = 2, 16
VLM, ENCODER = "llama-3.2-vision-11b", "hubert-xlarge"
CROSS_WEIGHTS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")


def _config(family, **kw):
    return dict(vocab_size=504, seq_len=S, batch_size=B, family=family,
                d_model=32, img_tokens=5 if family == "vlm" else 0, **kw)


def _assert_batch_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, t in got.items():
        w = np.asarray(want[k])
        assert t.dtype == (torch.int32 if w.dtype == np.int32 else torch.float32), k
        np.testing.assert_array_equal(t.numpy(), w)


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("family,keys", [
    ("audio", {"labels", "inputs_embeds"}),
    ("vlm", {"labels", "tokens", "img_embeds"})])
@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 2)])
def test_family_batches_bit_equal(family, keys, seed, shard, num_shards):
    """Frame or image embeddings drawn after the tokens from the same
    generator: bit-equal to the reference's, fp32, through steps, a
    reshard and a restored cursor."""
    kw = _config(family, seed=seed, shard=shard, num_shards=num_shards)
    it = pipeline.DataIterator(pipeline.PipelineConfig(**kw), device="cpu")
    jit = jpipe.DataIterator(jpipe.PipelineConfig(**kw))
    for _ in range(3):
        got, want = next(it), next(jit)
        assert set(got) == keys
        _assert_batch_equal(got, want)
    assert it.state_dict() == jit.state_dict()
    _assert_batch_equal(next(it.reshard(4, 3)), next(jit.reshard(4, 3)))
    it.load_state_dict({"step": 1})
    jit.load_state_dict({"step": 1})
    _assert_batch_equal(next(it), next(jit))


@pytest.mark.parametrize("family", ["audio", "vlm"])
def test_checkpoint_carries_the_cursor(tmp_path, family):
    """A cursor saved with the train state and restored goes on with the
    stream the reference's iterator gives, resharded too."""
    cfg = pipeline.PipelineConfig(**_config(family, seed=2))
    it = pipeline.DataIterator(cfg, device="cpu")
    for _ in range(3):
        next(it)
    ckpt = Checkpointer(tmp_path)
    tree = {"w": torch.ones(3), "data": {"step": torch.tensor(it.state_dict()["step"])}}
    ckpt.save(3, tree, blocking=True)
    step, back = ckpt.restore_latest(like=tree)
    fresh = pipeline.DataIterator(cfg, device="cpu")
    fresh.load_state_dict({"step": int(back["data"]["step"])})
    jit = jpipe.DataIterator(jpipe.PipelineConfig(**_config(family, seed=2)), step=3)
    assert step == 3 and fresh.state_dict() == jit.state_dict()
    _assert_batch_equal(next(fresh), next(jit))
    _assert_batch_equal(next(fresh.reshard(2, 1)), next(jit.reshard(2, 1)))


# ------------------------------------------------------------------- loss
@functools.lru_cache(maxsize=None)
def _seeded(arch):
    """Both packages' seeded smoke setups (the init: gates and biases 0)."""
    jcfg = jax_smoke_config(arch)
    jmodel, _, jstate, jpipe_, _ = jax_build(jcfg, batch_size=B, seq_len=S)
    cfg = smoke_config(arch)
    state = train_state_from_jax(jax.device_get(jstate), cfg, device="cpu")
    return jmodel, jstate["params"], jpipe_.cfg, cfg, state["params"]


def _grads(arch):
    jmodel, jparams, jpcfg, cfg, params = _seeded(arch)
    jbatch = jpipe.make_batch(jpcfg, 0)
    jg = jax.grad(lambda p: jmodel.loss(p, jbatch)[0])(jparams)
    want = _flat_from_jax(jax.device_get(jg), cfg, torch.device("cpu"))
    pcfg = pipeline.PipelineConfig(**jpcfg.__dict__)
    _, got, _ = make_loss_and_grads(cfg)(params, pipeline.make_batch(pcfg, 0, "cpu"))
    return cfg, got, want


def test_cross_weights_get_no_gradient_at_the_seeded_gates():
    """At the seeded gates, tanh(0) = 0 cuts the cross branch off: every
    weight of a cross layer gets an exactly zero gradient on both sides
    (why the train tests draw the gates), while the gates themselves and
    the self-attention layers' weights get one."""
    cfg, got, want = _grads(VLM)
    cross = [l for l, b in enumerate(cfg.pattern_layers) if b == "cross"]
    assert cross == [4, 9]
    for l in cross:
        for leaf in CROSS_WEIGHTS + ("mlp.wi", "mlp.wg", "mlp.wo", "norm1", "norm2"):
            name = f"blocks.{l}.{leaf}"
            assert not got[name].any() and not want[name].any(), name
        for gate in ("gate_attn", "gate_mlp"):
            assert got[f"blocks.{l}.{gate}"] != 0 and want[f"blocks.{l}.{gate}"] != 0
    assert got["blocks.0.attn.wk"].abs().max() > 0


# ------------------------------------------------------------ command line
@pytest.mark.parametrize("arch", [ENCODER, VLM])
def test_train_cli_trains_the_encoder_and_the_vlm(tmp_path, capsys, arch):
    """The command line trains both families on the CPU at smoke size: the
    one injected fault skipped, every other step ok."""
    rc = train_cli.main(["--device", "cpu", "--arch", arch, "--steps", "8",
                         "--batch", "2", "--seq", "16", "--inject", "3:nan_grad",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"])
    out = capsys.readouterr().out
    assert rc == 0 and "ok=7 faults=1" in out and "step 3: code=0x2" in out
    assert Checkpointer(tmp_path).list_steps() == [5]
