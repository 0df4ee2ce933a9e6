"""End-to-end resilient training, from the command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 50 --smoke --inject "12:nan_grad,25:spike_loss"

The port of ``repro/launch/train.py``. Wires together: model + optimizer +
deterministic pipeline + the paper's technique (in-band error channel →
DeviceFuture → RecoveryPolicy) + async checkpointing. ``--smoke`` (the
default) uses the reduced config, ``--full`` the published one; the run is
on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config, smoke_config
from ..core import ExecutorConfig, FaultSchedule, FaultSpec, ResilientExecutor
from ..core.detect import ProbeConfig
from ..core.recovery import RecoveryPolicy
from ..data.pipeline import DataIterator, PipelineConfig
from ..models import Model, resolve_device
from ..optim import AdamWConfig, init_opt_state
from ..weights import train_params
from .steps import make_reset_opt_fn, make_train_step


def parse_inject(spec: str) -> FaultSchedule:
    specs = []
    if spec:
        for part in spec.split(","):
            step_s, kind = part.split(":")
            specs.append(FaultSpec(step=int(step_s), kind=kind))
    return FaultSchedule(specs)


def build_train_setup(cfg, *, batch_size: int, seq_len: int, seed: int = 0,
                      lr: float = 3e-4, total_steps: int = 1000, device=None,
                      model: Optional[Model] = None,
                      probe_cfg: Optional[ProbeConfig] = None):
    """``(model, step_fn, state, pipe, opt_cfg)`` as the JAX package's.

    The state's params are a copy of ``model``'s weights (default: a fresh
    model drawn from ``seed`` on ``device``, ``cuda`` unless the caller
    passes another); the model itself is left as it was. ``probe_cfg``
    defaults to the JAX package's (divergence above a loss of 50)."""
    if model is None:
        model = Model(cfg, device=resolve_device(device), seed=seed)
    dev = model.device
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(total_steps // 20, 5),
                          total_steps=total_steps)
    probe_cfg = probe_cfg or ProbeConfig(loss_divergence_threshold=50.0)
    step_fn = make_train_step(cfg, opt_cfg, probe_cfg)
    params = train_params(model)
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev),
             "lr_scale": torch.ones((), dtype=torch.float32, device=dev)}
    pipe = DataIterator(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, batch_size=batch_size,
        seed=seed, family=cfg.family if cfg.family in ("audio", "vlm") else "lm",
        d_model=cfg.d_model, img_tokens=cfg.img_tokens), device=dev)
    return model, step_fn, state, pipe, opt_cfg


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--inject", default="", help="e.g. '12:nan_grad,25:spike_loss'")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model, step_fn, state, pipe, opt_cfg = build_train_setup(
        cfg, batch_size=args.batch, seq_len=args.seq, total_steps=args.steps,
        device=args.device)

    ckpt = Checkpointer(args.ckpt_dir)
    executor = ResilientExecutor(
        step_fn,
        policy=RecoveryPolicy(can_shrink=False),
        config=ExecutorConfig(good_state_interval=10,
                              checkpoint_interval=args.ckpt_every),
        checkpointer=ckpt,
        reset_opt_fn=make_reset_opt_fn(cfg),
    )
    faults = parse_inject(args.inject)

    t0 = time.monotonic()
    state, log = executor.run(state, pipe, args.steps, faults=faults)
    dt = time.monotonic() - t0
    ok = [e for e in log.events if e.kind == "ok"]
    fl = log.faults()
    print(f"\narch={cfg.name} device={model.device} steps={args.steps} "
          f"wall={dt:.1f}s ok={len(ok)} faults={len(fl)}")
    for e in fl:
        print(f"  step {e.step}: code={e.code:#x} action={e.action} ({e.detail})")
    ckpt.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
