"""The port keeps the public names of the JAX modules it copies or ports.

For each module below, every public name the reference module defines
(top-level functions, classes and assignments; a package's re-exports), and
every public attribute and dataclass field of each class both define, must
exist in the port, except the names listed in ``ABSENT``: each waits for
the ROADMAP item that ports its mode (11 tensor parallel, 12 multi-host,
13b elastic training, 14 MoE and the other architectures, 15b the dry-run
and roofline tools) or has no meaning without JAX (the reason is given).
Whole modules of the training path that wait are in ``WAITING``.

The modules are the host-side ones, whose API the port keeps. The model,
kernel and step modules (``models/``, ``kernels/``, ``launch/steps.py``'s
model functions) are left out: the port replaces JAX's functional
init-and-apply API by torch modules, and their own tests hold them to the
reference's numbers.
"""
import ast
import dataclasses
import importlib
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"

MODULES = (
    "configs/__init__.py", "configs/base.py", "configs/registry.py",
    "core/__init__.py", "core/errors.py", "core/faults.py",
    "core/recovery.py", "core/device_channel.py", "core/detect.py",
    "core/resilient.py", "core/transport.py", "core/future.py",
    "core/blackchannel.py", "core/ulfm.py", "core/comm.py",
    "core/instance.py", "launch/paging.py", "launch/train.py",
    "optim/__init__.py", "optim/adamw.py", "data/pipeline.py",
    "checkpoint/__init__.py", "checkpoint/checkpointer.py",
    "serve/__init__.py", "serve/config.py", "serve/queue.py",
    "serve/scheduler.py", "serve/replica.py", "serve/group.py",
    "serve/ledger.py", "serve/metrics.py",
    "obs/__init__.py", "obs/trace.py", "obs/postmortem.py",
    "fuzz/__init__.py", "fuzz/trajectory.py", "fuzz/coverage.py",
    "fuzz/mutator.py", "fuzz/runner.py", "fuzz/campaign.py",
)

_TP = "ROADMAP item 11 (tensor parallel)"
_MULTIHOST = "ROADMAP item 12 (multi-host)"
_ELASTIC = "ROADMAP item 13b (elastic training and the buddy store)"
_MOE = "ROADMAP item 14 (MoE and the other architectures)"
_DRYRUN = "ROADMAP item 15b (dry run and roofline)"
_SERVE_ENUM = ("JAX-only: jitted factories; the port's replica runs "
               "slot_enum / window_enum directly")

ABSENT = {
    "configs/__init__.py": {
        "SHAPES": _DRYRUN, "SMOKE_SHAPE": _DRYRUN, "ShapeConfig": _DRYRUN,
        "all_cells": _DRYRUN, "cell_skip_reason": _DRYRUN},
    "configs/base.py": {
        "SHAPES": _DRYRUN, "ShapeConfig": _DRYRUN,
        "ModelConfig.params_count": _DRYRUN,
        "ModelConfig.active_params_count": _DRYRUN,
        "ModelConfig.subquadratic": _DRYRUN,
        "ModelConfig.has_global_attention": _DRYRUN,
        "ModelConfig.is_encoder": _MOE},
    "configs/registry.py": {
        "SMOKE_SHAPE": _DRYRUN, "all_cells": _DRYRUN,
        "cell_skip_reason": _DRYRUN},
    "core/__init__.py": {"make_enumerate_fn": _TP},
    "core/detect.py": {
        "router_probe": _MOE, "ProbeConfig.router_drop_threshold": _MOE,
        "ProbeConfig.use_kernel": ("JAX-only: the reference's serve probes "
                                   "skip its Pallas kernel; the port's "
                                   "probes are the kernel on the card")},
    "core/device_channel.py": {
        "make_enumerate_fn": _TP, "enumeration_shard_body": _TP},
    "checkpoint/__init__.py": {"BuddyStore": _ELASTIC},
    "launch/paging.py": {"PagedLayout.tp_storage_specs": _TP},
    "serve/__init__.py": {
        "MultiHostResult": _MULTIHOST, "MultiHostSupervisor": _MULTIHOST,
        "PhiAccrualDetector": _MULTIHOST, "sim_tokens": _MULTIHOST},
    "serve/config.py": {
        "EngineConfig.donate": ("JAX-only: buffer donation; the port's "
                                "caches update in place")},
    "serve/replica.py": {
        "SERVE_PROBES": ("JAX-only here: the port keeps it in "
                         "core/detect.py, where its probes live"),
        "make_enum_fn": _SERVE_ENUM, "make_window_enum_fn": _SERVE_ENUM},
    "fuzz/runner.py": {
        "MULTIHOST_SUSPECT_TIMEOUT": _MULTIHOST,
        "MULTIHOST_STOP_PAUSE": _MULTIHOST,
        **dict.fromkeys(
            ("EngineKit.params", "EngineKit.decode_fn", "EngineKit.prefill_fn",
             "EngineKit.window_fn", "EngineKit.layout"),
            "JAX-only: the kit's compiled functions; the port's kit carries "
            "the model, and each replica builds its own steps")},
}


# reference modules of the training path with no counterpart yet, and what
# waits in them with its item
WAITING = {
    "checkpoint/buddy.py": "ROADMAP item 13b (BuddyStore)",
    "launch/elastic.py": ("ROADMAP item 13b (ElasticTrainer, elastic_train); "
                          "item 11 (shrink_remesh, over sharding/)"),
    "optim/compress.py": "ROADMAP item 11 (compressed_psum, a collective)",
}


def _defined(path: pathlib.Path) -> set:
    """The public names ``path`` defines at top level (a package's
    ``__init__`` also: what it re-exports from its own submodules)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and node.level >= 1
              and path.name == "__init__.py"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _module(package: str, rel: str):
    name = rel[:-3].replace("/", ".").removesuffix(".__init__")
    return importlib.import_module(f"{package}.{name}")


def _members(cls) -> set:
    out = {n for n in dir(cls) if not n.startswith("_")}
    if dataclasses.is_dataclass(cls):
        out |= {f.name for f in dataclasses.fields(cls)}
    return out


def _missing(rel: str) -> set:
    ref_names = _defined(ROOT / "repro" / rel)
    port_names = _defined(ROOT / "repro_torch" / rel)
    missing = ref_names - port_names
    ref, port = _module("repro", rel), _module("repro_torch", rel)
    for name in sorted(ref_names & port_names):
        a, b = getattr(ref, name), getattr(port, name)
        if (inspect.isclass(a) and inspect.isclass(b)
                and a.__module__ == ref.__name__):      # defined here
            missing |= {f"{name}.{m}" for m in _members(a) - _members(b)}
    return missing


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_are_kept(rel):
    assert (ROOT / "repro_torch" / rel).exists(), rel
    assert _missing(rel) == set(ABSENT.get(rel, {})), rel


@pytest.mark.parametrize("rel", sorted(WAITING))
def test_waiting_modules_are_named_with_their_item(rel):
    assert (ROOT / "repro" / rel).exists(), rel
    assert not (ROOT / "repro_torch" / rel).exists(), rel
    assert WAITING[rel].startswith("ROADMAP item")


def test_every_absent_name_says_why():
    assert set(ABSENT) <= set(MODULES)
    for rel, names in ABSENT.items():
        for name, why in names.items():
            assert why.startswith(("ROADMAP item", "JAX-only")), (rel, name)


def test_repaired_names_keep_their_meaning():
    """The names ROADMAP Queue 3 item 3 found missing, each with the
    reference's meaning."""
    from repro.core.errors import ErrorCode as JaxErrorCode
    from repro.core.faults import FaultSchedule as JaxSchedule
    from repro.core.faults import FaultSpec as JaxSpec
    from repro.serve.config import EngineConfig as JaxEngineConfig
    from repro_torch.core.errors import ErrorCode, PropagatedError, RankError
    from repro_torch.core.faults import FaultSchedule, FaultSpec
    from repro_torch.core.recovery import Action, RecoveryPolicy
    from repro_torch.serve import (AdmissionPolicy, ContinuousBatchingScheduler,
                                   EngineConfig, Request, RequestQueue)

    for code in list(ErrorCode):
        assert (code.is_hard, code.is_soft) == (
            JaxErrorCode(int(code)).is_hard, JaxErrorCode(int(code)).is_soft)
    exc = PropagatedError([RankError(rank=2, code=8), RankError(rank=0, code=1)])
    assert exc.ranks == (2, 0) and exc.errors[0].error_code is ErrorCode.OVERFLOW
    specs = [dict(step=1, kind="nan_loss", rank=0), dict(step=1, kind="kill", rank=1),
             dict(step=1, kind="code", rank=0, code=int(ErrorCode.OVERFLOW)),
             dict(step=2, kind="straggle", rank=0)]
    mine = FaultSchedule([FaultSpec(**s) for s in specs])
    ref = JaxSchedule([JaxSpec(**s) for s in specs])
    for step in (1, 2):
        for rank in (None, 0, 1):
            assert mine.inject_word(step, rank) == ref.inject_word(step, rank)
            assert mine.code_word(step, rank) == ref.code_word(step, rank)
    assert [s.kind for s in mine.device_faults()] == [s.kind for s in ref.device_faults()]
    assert [s.kind for s in mine.host_faults()] == [s.kind for s in ref.host_faults()]
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSchedule([FaultSpec(step=0, kind="bogus")]).inject_word(0)
    policy = RecoveryPolicy()
    first = policy.decide(exc, 1).action
    assert policy.decide(exc, 2).action is Action.RESTORE_GOOD
    policy.reset()
    assert policy.decide(exc, 3).action is first is Action.SKIP_BATCH
    for flags, kw in (("win=8,spec=1,dlen=3", {}), ("win=4,paged,page=16", {"num_slots": 3}),
                      ("trace=1,trace_sample=0.25", {})):
        got = dataclasses.asdict(EngineConfig.from_flags(flags, **kw))
        want = dataclasses.asdict(JaxEngineConfig.from_flags(flags, **kw))
        assert got == {k: v for k, v in want.items() if k != "donate"}
    with pytest.raises(ValueError, match="unknown engine flag"):
        EngineConfig.from_flags("windw=8")
    with pytest.raises(ValueError, match="trace_sample"):
        EngineConfig(trace_sample=2.0)
    queue = RequestQueue(AdmissionPolicy(max_total_len=8))
    rejected = queue.submit_all([Request(id=0, prompt=(1, 2), max_new_tokens=2),
                                 Request(id=1, prompt=(1,) * 9, max_new_tokens=2)])
    assert [r.id for r in rejected] == [1] and len(queue) == 1
    sched = ContinuousBatchingScheduler(2, queue)
    sched.backfill(0.0)
    assert sched.prefilling_slots() == []
    sched.begin_prefill(0)
    assert sched.prefilling_slots() == [0]
    drained = sched.drain_in_flight()
    assert [r.id for r in drained] == [0] and not sched.has_active()
