"""The port's ``Checkpointer`` against the JAX package's: background atomic
writes, a per-leaf CRC manifest, corrupt checkpoints skipped by
``restore_latest``, old ones collected — and the port's state trees (dicts
of tensors, bfloat16 leaves among them) coming back bit for bit on the
device of the state they are restored into."""
import json

import jax
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import smoke_config
from repro_torch.core.device_channel import readback
from repro_torch.launch.train import build_train_setup


def _state(seed: int, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn(16, 8, generator=gen).to(dtype),
              "blocks.0.attn.wq": torch.randn(8, 2, 4, generator=gen).to(dtype),
              "final_norm": torch.randn(8, generator=gen)}
    params["embed"].view(-1)[3] = float("nan")          # kept bit for bit too
    return {"params": params,
            "opt": {"m": {k: torch.randn(v.shape, generator=gen)
                          for k, v in params.items()},
                    "v": {k: torch.rand(v.shape, generator=gen)
                          for k, v in params.items()}},
            "step": torch.tensor(seed, dtype=torch.int32),
            "lr_scale": torch.tensor(0.5)}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.device == b.device and a.shape == b.shape
            and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else
                            a.view(torch.int32), b.view(torch.int16)
                            if b.dtype == torch.bfloat16 else b.view(torch.int32)))


def test_round_trip_bit_for_bit(tmp_path):
    ck = Checkpointer(tmp_path)
    state = _state(3)
    before = readback.count
    ck.save(3, state, blocking=True)
    assert readback.count == before + 11           # one host copy per leaf
    assert ck.last_error is None and ck.list_steps() == [3]
    step, got = ck.restore_latest(like=_state(9))
    assert step == 3 and _equal(got, state)


def test_smoke_train_state_round_trip(tmp_path):
    cfg = smoke_config("qwen3-1.7b").replace(dtype="bfloat16")
    _, _, state, _, _ = build_train_setup(cfg, batch_size=2, seq_len=8,
                                          device="cpu")
    ck = Checkpointer(tmp_path)
    ck.save(0, state, blocking=True)
    manifest = json.loads((tmp_path / "step-0000000000" / "manifest.json").read_text())
    assert manifest["num_leaves"] == 3 * len(state["params"]) + 2
    assert manifest["leaves"][0]["path"] == "params/embed"
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    _, got = ck.restore_latest(like=state)
    assert _equal(got, state)


def _corrupt(path, step: int, leaf: int) -> None:
    f = path / f"step-{step:010d}" / f"leaf-{leaf:05d}.npy"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))


@pytest.mark.parametrize("leaf", [0, 9])
def test_corrupt_checkpoint_is_skipped_as_in_jax(tmp_path, leaf):
    ours, theirs = Checkpointer(tmp_path / "t"), JaxCheckpointer(tmp_path / "j")
    for step in (10, 20):
        state = _state(step, torch.float32)
        ours.save(step, state, blocking=True)
        theirs.save(step, jax.tree_util.tree_map(lambda t: t.numpy(), state),
                    blocking=True)
    _corrupt(tmp_path / "t", 20, leaf)
    _corrupt(tmp_path / "j", 20, leaf)
    with pytest.raises(IOError, match="CRC mismatch"):
        ours.restore(20, _state(0, torch.float32))
    like = _state(0, torch.float32)
    step, got = ours.restore_latest(like=like)
    jstep, _ = theirs.restore_latest(like=jax.tree_util.tree_map(lambda t: t.numpy(), like))
    assert step == jstep == 10 and _equal(got, _state(10, torch.float32))


def test_keep_and_mismatch(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for step in (1, 2, 3):
        ck.save(step, _state(step))
    ck.wait()
    assert ck.list_steps() == [2, 3]
    assert not list(tmp_path.glob("tmp-*"))        # published by rename only
    other = _state(0)
    other["params"]["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="leaf count"):
        ck.restore(3, other)
    renamed = _state(0)
    renamed["params"] = {("x" + k): v for k, v in renamed["params"].items()}
    with pytest.raises(ValueError, match="expected"):
        ck.restore(3, renamed)
    assert ck.restore_latest(like=other) is None
