"""The port stands alone: nothing under ``src/repro_torch`` and nothing in
its scripts (``chip_smoke.py``, ``scripts/profile_torch_serve.py``,
``scripts/trace_tool_torch.py``, ``scripts/fuzz_torch.py``) imports
``jax`` or the JAX package ``repro``; and its entry points run on the card unless the caller asks for the CPU — without a card
they raise instead of running on the CPU."""
import ast
import pathlib

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.device_channel import DeviceFuture
from repro_torch.data.pipeline import DataIterator, PipelineConfig, make_batch
from repro_torch.launch.train import build_train_setup
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model
from repro_torch.serve import EngineConfig, Replica, ServeGroup
from repro_torch.weights import cache_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + [
        ROOT / "scripts" / f"{name}.py"
        for name in ("profile_torch_serve", "trace_tool_torch", "fuzz_torch")]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


# the port's copies of modules of the JAX package that import no JAX
COPIES = ("core/transport.py", "core/future.py", "core/blackchannel.py",
          "core/ulfm.py", "core/comm.py", "core/instance.py",
          "core/faults.py", "serve/ledger.py", "serve/group.py",
          "obs/trace.py", "obs/postmortem.py", "fuzz/trajectory.py",
          "fuzz/coverage.py")


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in files if "repro_torch" in p.parts}
    assert set(COPIES) <= names
    bad = [(str(p.relative_to(ROOT)), name) for p in files for name in _imports(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_the_card():
    """Without ``device=`` every entry point targets CUDA; on a machine
    without a card that raises — it never runs on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    cfg = smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Replica(cfg, config=EngineConfig(window=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeGroup(cfg, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        cache_from_jax({"periods": {}, "rest": []}, cfg.replace(num_layers=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_train_setup(cfg, batch_size=2, seq_len=8)
    pipe = PipelineConfig(vocab_size=cfg.vocab_size, seq_len=8, batch_size=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataIterator(pipe)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(pipe, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "qwen3-1.7b", "--steps", "1"])
    Model(cfg, device="cpu")                    # the CPU only when asked


def test_cpu_future_is_ready_at_dispatch():
    fut = DeviceFuture(outputs=1, word=torch.zeros((), dtype=torch.int32))
    assert fut.done() and fut.wait() == 1
