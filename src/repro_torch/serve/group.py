"""ServeGroup: N replicas on the thread-rank transport, ULFM fault handling.

The port of ``repro/serve/group.py``. Each rank thread owns one
:class:`~repro_torch.serve.replica.Replica` and serves its share of the
request ledger. Every round the ranks exchange health + remaining load
through a fault-aware ``Comm.all_reduce`` — the same choke point the paper
routes everything through: the wait either returns the reduction or raises
the unified exceptions.

Hard fault choreography:

1. a replica dies (``ctx.die`` — simulated node loss);
2. survivors' next health exchange fails; the ULFM protocol revokes, agrees,
   and every survivor raises ``CommCorruptedError`` — *no deadlock*: nobody
   waits on the dead rank;
3. survivors ``shrink_to_survivors`` and re-route: the ledger
   deterministically reassigns the dead rank's unanswered requests across
   survivors (``id % n_survivors`` over the sorted survivor list, no extra
   communication), and serving continues without a global restart;
4. re-routed requests are recomputed from their prompts on the new owner —
   accepted requests are *answered*, never dropped.

The elastic layer extends the same machinery: every membership change
(fault shrink, join, autoscale grow/shrink) is an *epoch* proposal on the
shared :class:`~repro_torch.serve.ledger.GroupLedger`, entered by all active
ranks at the same exchange; a joining spare meets the group on a
communicator from the non-collective ``Comm.repair``; with ``ledger_path``
every submit / route / retirement is a checksummed, fsync'd WAL record and
:meth:`ServeGroup.serve_from_ledger` restarts a crashed fleet from the log
alone; the leader's :class:`AutoscalePolicy` drives the same epoch path.

Soft faults stay replica-local (per-sequence LFLR inside ``Replica``); the
group only learns about them through metrics.

How the port differs: one :class:`~repro_torch.models.Model` on the device
is shared by every rank's ``Replica`` (the JAX group shares its params);
each ``Replica`` builds its own caches and step closures (eager PyTorch has
no compiled program to share); the rank threads launch on the device's
default stream, and take turns through one lock around each replica's step.
One interpreter runs one thread's launches at a time anyway, and threads
left to contend for it were slower: on an H100 a full-width qwen3 round of
three ranks took 1.05–1.11 s that way, about twice the three windows one
after another (likely each torch call that lets the interpreter go hands
it to another rank and waits to get it back). With ``trace=True`` each rank
records into its own :class:`~repro_torch.obs.Tracer` (``pid`` = rank), the
replica's events under the step lock, the group's outside it; none calls
into torch. ``tp > 1`` raises ``NotImplementedError`` (ROADMAP item 11).
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from ..core import CommCorruptedError, PropagatedError, initialize, run_ranks
from ..core.faults import FaultSchedule
from ..core.transport import RankResult
from ..kernels.build import library
from ..launch.paging import PagedLayout
from ..models.model import Model
from .config import EngineConfig
from .ledger import GroupLedger, WriteAheadLog
from .ledger import replay as replay_ledger
from .metrics import ServeMetrics
from .queue import AdmissionPolicy, Request, RequestQueue, Response
from ..obs.trace import NULL_TRACER, Tracer, merge_traces
from .replica import Replica, _check_supported

# chunking of the simulated join-time state transfer: enough chunks (with a
# short host pause each) that the join window spans several decode rounds
_TRANSFER_CHUNKS = 6
_TRANSFER_PAUSE_S = 0.002


@dataclass(frozen=True)
class AutoscalePolicy:
    """Hysteresis-guarded elastic sizing policy for a :class:`ServeGroup`.

    The leader samples pressure every round: *hot* when the ledger backlog
    (accepted but unassigned requests) reaches ``queue_high`` or the
    leader's own TTFT p99 exceeds ``ttft_high``; *idle* when the backlog is
    empty. ``grow_sustain`` consecutive hot rounds summon a dormant spare;
    ``shrink_idle`` consecutive idle rounds drain the highest live rank out
    through a graceful epoch. ``cooldown`` rounds must separate consecutive
    membership changes."""

    queue_high: int = 4
    ttft_high: Optional[float] = None      # seconds, None = queue-depth only
    grow_sustain: int = 3
    shrink_idle: int = 6
    cooldown: int = 8
    min_ranks: int = 2


@dataclass(frozen=True)
class AgreeDecision:
    """Outcome of one agreement round: what a member does with the folded
    ``[remaining, epoch]`` pair."""

    action: str      # "reconfigure" | "hold" | "close" | "continue"
    epoch: int       # the epoch to serve under after acting


def agree_round(rem: int, agreed: int, my_epoch: int, *,
                hold_close: bool = False) -> AgreeDecision:
    """The transport-neutral half of the agreement: interpret the
    emax-folded ``[remaining, epoch]`` pair against this member's epoch.

    * a newer epoch wins over everything (**reconfigure**: enter it before
      serving another round);
    * ``rem == 0`` **close**s the group — unless ``hold_close`` (a pending
      join or a proposal that landed after this round's fold) asks to spin
      one more round;
    * otherwise **continue** serving.
    """
    if agreed > my_epoch:
        return AgreeDecision("reconfigure", agreed)
    if rem == 0:
        return AgreeDecision("hold" if hold_close else "close", my_epoch)
    return AgreeDecision("continue", my_epoch)


@dataclass
class RankReport:
    rank: int
    rounds: int = 0
    events: list = field(default_factory=list)   # ("shrink"|"propagated", round, info)
    metrics: Optional[ServeMetrics] = None
    round_s: list = field(default_factory=list)  # wall seconds of each round


@dataclass
class GroupResult:
    responses: dict[int, Response]
    reports: list[RankResult]                    # raw per-rank harness results
    rerouted: tuple[int, ...] = ()
    rebalanced: tuple[int, ...] = ()             # moved by epoch re-balance
    joined: tuple[int, ...] = ()                 # ranks admitted via join
    autoscale: tuple[dict, ...] = ()             # leader grow/shrink decisions
    epoch: int = 0                               # final membership epoch
    crashed: bool = False                        # fleet stopped mid-serve
    replayed: tuple[int, ...] = ()               # ids re-admitted from a WAL
    tracers: dict[int, Tracer] = field(default_factory=dict)

    @property
    def ok(self) -> dict[int, Response]:
        return {i: r for i, r in self.responses.items() if r.ok}

    def report(self, rank: int) -> Optional[RankReport]:
        rr = self.reports[rank]
        return rr.value if rr.exception is None and not rr.killed else None

    def merged_metrics(self) -> ServeMetrics:
        """Survivor replicas' metrics pooled into one accumulator (sums,
        max-of-peaks, pooled response populations for percentiles)."""
        parts = [rr.value.metrics for rr in self.reports
                 if rr.exception is None and not rr.killed
                 and rr.value is not None and rr.value.metrics is not None]
        return ServeMetrics.merged(parts)

    def summary(self) -> dict:
        """One fleet-level dict: the merged per-replica metrics plus the
        group's own story (replica count, survivors, re-routes)."""
        out = self.merged_metrics().summary()
        # a dormant spare that was never summoned returns None without
        # serving — it participated in nothing and counts as nothing
        out["replicas"] = sum(1 for rr in self.reports
                              if rr.killed or rr.exception is not None
                              or rr.value is not None)
        out["survivors"] = sum(1 for rr in self.reports
                               if rr.exception is None and not rr.killed
                               and rr.value is not None)
        out["rerouted"] = len(self.rerouted)
        if self.joined:
            out["joined"] = len(self.joined)
        if self.rebalanced:
            out["rebalanced"] = len(self.rebalanced)
        if self.autoscale:
            out["autoscale"] = len(self.autoscale)
        if self.crashed:
            out["crashed"] = True
        return out

    def trace(self) -> dict:
        """All ranks' tracers (dead ones included: their events are the
        cause half of the kill → shrink → re-route chain) merged into one
        trace_event object."""
        return merge_traces(*(self.tracers[r] for r in sorted(self.tracers)))


class ServeGroup:
    """A fleet of serving replicas over the simulated multi-rank runtime,
    sharing one model on one device."""

    def __init__(self, cfg, nranks: int, *,
                 model: Optional[Model] = None,
                 config: Optional[EngineConfig] = None,
                 device=None, seed: int = 0,
                 timeout: float = 30.0,
                 max_ranks: Optional[int] = None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 transfer_chunks: int = _TRANSFER_CHUNKS,
                 transfer_pause_s: float = _TRANSFER_PAUSE_S):
        # the reference group's default engine: the stepwise engine, 2 slots
        config = config if config is not None else EngineConfig(num_slots=2)
        _check_supported(config)
        if nranks < 2:
            raise ValueError("a ServeGroup needs >= 2 replicas")
        if model is not None and device is not None and (
                torch.device(device) != model.device):
            raise ValueError(f"model lives on {model.device}, not {device}")
        self.config = config
        self.cfg = cfg
        self.nranks = nranks
        self.max_ranks = max(nranks, int(max_ranks or nranks))
        self.autoscale = autoscale
        self.transfer_chunks = int(transfer_chunks)
        self.transfer_pause_s = float(transfer_pause_s)
        self.num_slots = config.num_slots
        self.max_len = config.max_len
        self.timeout = timeout
        self.paged = bool(config.paged)
        self.trace = bool(config.trace)
        self.trace_sample = float(config.trace_sample)
        # one model on the device, shared by every rank's replica
        self.model = model if model is not None else Model(cfg, device=device,
                                                           seed=seed)
        self.device = self.model.device
        # the page pool's shape (each replica owns its own pool): a request
        # that could never fit it is REJECTED at submit
        self._layout = None
        if self.paged:
            num_pages = (int(config.page_budget)
                         if config.page_budget is not None
                         else self.num_slots * (self.max_len // config.page_size))
            self._layout = PagedLayout(self.model.init_cache(1, self.max_len),
                                       self.max_len,
                                       page_size=config.page_size,
                                       num_pages=num_pages)
        if self.device.type == "cuda":
            # build and load the kernels now: a first build inside round 0
            # would count against the collective timeout
            library()

    # ------------------------------------------------------------ entry points
    def serve(self, requests: Sequence[Request], *,
              faults: FaultSchedule | None = None,
              max_rounds: int = 10_000,
              ledger_path: Optional[str] = None,
              crash_at: Optional[int] = None,
              joins: Optional[Sequence[int]] = None) -> GroupResult:
        """Serve ``requests`` to completion across the group.

        ``faults`` uses :class:`FaultSpec` with ``step`` meaning the serving
        *round*: ``kind="kill"`` (or ``"shard_kill"``) hard-kills a replica
        at the top of that round; ``kind="state_nan"`` poisons one of its
        active sequences, in a slot drawn from the schedule's per-(rank,
        round) generator; wildcard ranks resolve from the schedule's seed.

        ``ledger_path`` mirrors the ledger into a durable write-ahead log
        (see :meth:`serve_from_ledger`); ``crash_at`` stops the *whole
        fleet* at the top of that round — every rank dies, only the WAL
        survives; ``joins`` lists rounds at which the leader summons a
        dormant spare rank (``max_ranks`` > ``nranks`` provisions them).
        """
        wal = WriteAheadLog(ledger_path) if ledger_path else None
        ledger = GroupLedger(
            requests, range(self.nranks),
            spares=range(self.nranks, self.max_ranks), wal=wal)
        return self._run(ledger, actives=tuple(range(self.nranks)),
                         faults=faults, max_rounds=max_rounds,
                         crash_at=crash_at, joins=joins)

    def serve_from_ledger(self, ledger_path: str, *,
                          faults: FaultSchedule | None = None,
                          max_rounds: int = 10_000,
                          crash_at: Optional[int] = None,
                          joins: Optional[Sequence[int]] = None) -> GroupResult:
        """Restart a crashed fleet from its write-ahead log alone.

        :func:`~repro_torch.serve.ledger.replay` reconstructs the ledger
        (answered requests return bit-exact from their ``retire`` records;
        a torn final record is discarded), the last logged epoch's members
        come back as the active set, every other rank up to ``max_ranks``
        becomes a spare available for regrow, and the outstanding requests
        re-enter serving through the negative-sequence requeue lane with
        their original arrival times and trace ids."""
        rep = replay_ledger(ledger_path)
        if not rep.members:
            raise ValueError(f"{ledger_path}: no epoch record to restart from")
        members = tuple(m for m in rep.members if m < self.max_ranks)
        if len(members) < 2:
            raise ValueError(
                f"{ledger_path}: epoch members {rep.members} leave fewer "
                f"than 2 restartable ranks (max_ranks={self.max_ranks})")
        outstanding = rep.outstanding()
        wal = WriteAheadLog(ledger_path)     # truncates any torn tail
        ledger = GroupLedger(
            outstanding, members,
            spares=[r for r in range(self.max_ranks) if r not in members],
            wal=wal, responses=rep.responses,
            replayed=[r.id for r in outstanding],
            stamped=[r.id for r in outstanding if r.arrival_t is not None],
            epoch0=rep.epoch, epoch_reason="replay", log_submits=False)
        return self._run(ledger, actives=members, faults=faults,
                         max_rounds=max_rounds, crash_at=crash_at,
                         joins=joins, replay_info=rep)

    # ------------------------------------------------------------- the machine
    def _run(self, ledger: GroupLedger, *, actives: tuple[int, ...],
             faults: FaultSchedule | None, max_rounds: int,
             crash_at: Optional[int], joins: Optional[Sequence[int]],
             replay_info=None) -> GroupResult:
        faults = (faults or FaultSchedule()).resolve(sorted(actives))
        policy = self.autoscale
        joins_at = Counter(int(r) for r in (joins or ()))
        launched = self.max_ranks if self.max_ranks > len(actives) else self.nranks
        # elastic mode throttles `take` to replica capacity so a widened
        # group finds untaken work to re-balance; the classic fixed group
        # drains everything at once
        elastic = (launched > len(actives) or policy is not None
                   or ledger.wal is not None or crash_at is not None
                   or bool(joins_at))

        # a request that could never fit a replica's page pool must be
        # REJECTED at submit (the clamp Replica applies to its own queue)
        pool_cap = (self._layout.capacity_tokens
                    if self.paged and self._layout.has_paged_leaves
                    else self.max_len)

        ledger.publish_state({
            "params_bytes": int(sum(p.numel() * p.element_size()
                                    for p in self.model.parameters())),
            "paged": self.paged,
            "num_pages": (self._layout.num_pages if self.paged else 0),
        })
        epoch0 = ledger.epoch
        step_lock = threading.Lock()     # the rank threads' turns (docstring)
        tracers: dict[int, Tracer] = {}
        leader0 = min(actives)

        def make_tracer(rank: int) -> Tracer:
            if not self.trace:
                return NULL_TRACER
            tracer = Tracer(pid=rank, sample=self.trace_sample)
            # registered up front, so a killed rank's events outlive it
            tracers[rank] = tracer
            return tracer

        def build_replica(rank: int, tracer: Tracer) -> Replica:
            queue = RequestQueue(AdmissionPolicy(
                max_queue=10_000, max_total_len=pool_cap), tracer=tracer)
            return Replica(self.cfg, self.model, config=self.config,
                           queue=queue, rank=rank)

        def reroutes(tracer: Tracer, moved) -> None:
            for rid, old, new in moved:
                tracer.instant("reroute", "group",
                               trace_id=ledger.requests[rid].trace_id,
                               request=rid, from_rank=old, to_rank=new)

        def serve_rounds(ctx, comm, replica, tracer, report, my_epoch, *,
                         inject_faults=True):
            """The per-rank round loop — initial actives and joiners alike.

            ``round_i`` frames are aligned across the initial actives (every
            iteration is one collective exchange), so ``crash_at`` and the
            fault schedule fire coherently; a joiner counts its own rounds
            from 0 and therefore neither re-fires the schedule nor triggers
            ``crash_at`` itself — it learns of a fleet stop through the
            ledger flag."""
            t_round = None
            for round_i in range(max_rounds):
                # a round's wall time runs from the top of its loop to the
                # top of the next (the step and the exchange)
                now = time.perf_counter()
                if t_round is not None:
                    report.round_s.append(now - t_round)
                t_round = now
                # ---- fleet stop: the WAL is all that survives
                if (crash_at is not None and round_i == crash_at
                        and inject_faults) or ledger.crashed:
                    ledger.crash()
                    if tracer.enabled:
                        tracer.instant("fleet_stop", "group", rank=ctx.rank,
                                       round=round_i)
                    ctx.die()                           # never returns
                for spec in (faults.at(round_i, ctx.rank)
                             if inject_faults else ()):
                    if spec.kind in ("kill", "shard_kill"):
                        # a TP shard loss takes its whole replica (one SPMD
                        # program) down: the same hard fault as a kill (its
                        # shard_loss event waits for ROADMAP item 11)
                        if tracer.enabled:
                            tracer.instant("replica_kill", "group",
                                           rank=ctx.rank, round=round_i)
                        ctx.die()                       # never returns
                    elif spec.kind == "state_nan":
                        slot = replica.inject_state_fault(
                            rng=faults.rng_for(ctx.rank, round_i))
                        if slot is not None:
                            report.events.append(("inject", round_i, slot))
                leader = min(ledger.members)
                if ctx.rank == leader and not ledger.stopped:
                    for _ in range(joins_at.get(round_i, 0)):
                        summoned = ledger.summon_next("scheduled")
                        if summoned is not None:
                            report.events.append(
                                ("summon", round_i, summoned))
                    if policy is not None:
                        self._autoscale_tick(ledger, policy, replica,
                                             round_i, report, tracer)
                # ---- graceful autoscale leave: drain, then propose the
                # epoch that excludes us and keep exchanging until agreed
                if ledger.leaving == ctx.rank and replica.idle():
                    left = ledger.depart(ctx.rank)
                    report.events.append(("depart", round_i, left))
                    if tracer.enabled:
                        tracer.instant("autoscale", "group", action="depart",
                                       rank=ctx.rank, epoch=left,
                                       round=round_i)
                if ledger.leaving != ctx.rank:
                    limit = (None if not elastic else
                             max(0, 2 * self.num_slots - replica.load()))
                    for req in ledger.take(ctx.rank, limit):
                        if (req.id in ledger.replayed
                                and req.arrival_t is not None):
                            rej = replica.readmit(req)
                        else:
                            rej = replica.submit(req)
                        if rej is None:
                            ledger.note_stamp(req)
                        else:
                            ledger.complete(rej)
                with step_lock:
                    answered = replica.step()
                for resp in answered:
                    ledger.complete(resp)
                report.rounds = round_i + 1
                # fault-aware health/termination/epoch exchange: the one wait
                # that either agrees on progress or raises the paper's
                # exceptions; the elementwise max gives every rank of the
                # epoch the same [remaining, newest-epoch] pair
                try:
                    rem, agreed = comm.all_reduce(
                        [ledger.remaining(), ledger.epoch], op="emax").wait()
                except PropagatedError as exc:
                    report.events.append(
                        ("propagated", round_i,
                         [e.rank for e in exc.errors]))
                    continue
                except CommCorruptedError:
                    prev = tuple(comm.context.members)
                    comm.shrink_to_survivors()
                    survivors = list(comm.context.members)
                    moved = ledger.on_death(set(prev) - set(survivors))
                    if tracer.enabled:
                        tracer.instant("ulfm_shrink", "group", rank=ctx.rank,
                                       round=round_i,
                                       survivors=sorted(survivors))
                        reroutes(tracer, moved)
                    report.events.append(("shrink", round_i, len(survivors)))
                    if moved:
                        report.events.append(
                            ("reroute", round_i, [r for r, _, _ in moved]))
                    continue
                # hold the final close while a scheduled joiner is still
                # warming up, or while a membership proposal landed after
                # this round's exchange read the epoch
                decision = agree_round(
                    rem, agreed, my_epoch,
                    hold_close=(ledger.has_pending_joins()
                                or ledger.epoch > agreed))
                if decision.action == "reconfigure":
                    # first entrant re-balances untaken work over the new
                    # member list, everyone re-keys the comm
                    moved = ledger.enter_epoch(decision.epoch)
                    members = ledger.members_of(decision.epoch)
                    if tracer.enabled:
                        reroutes(tracer, moved)
                    if moved:
                        report.events.append(
                            ("rebalance", round_i, [r for r, _, _ in moved]))
                    report.events.append(("epoch", round_i, decision.epoch))
                    if ctx.rank not in members:
                        return report       # our graceful leave is agreed
                    if tuple(sorted(comm.context.members)) != members:
                        comm = comm.repair(members,
                                           ("serve-epoch", decision.epoch))
                    my_epoch = decision.epoch
                    continue    # ≥1 exchange on the new epoch before exit
                if decision.action == "hold":
                    time.sleep(0.002)
                    continue
                if decision.action == "close":
                    ledger.close()
                    return report
            raise RuntimeError(
                f"rank {ctx.rank}: no global progress in {max_rounds} rounds "
                f"({ledger.remaining()} requests unanswered)")

        def join_rank(ctx, inst, tracer, replica, reason: str,
                      t_join0: float):
            """Warm spare → serving member, without stalling survivors:
            receive state as a background lane, propose the widened epoch,
            meet the group on the repaired communicator."""
            snap = ledger.state_snapshot or {}
            t_xfer0 = time.monotonic()
            for _ in range(self.transfer_chunks):
                if ledger.stopped:
                    ledger.abandon_join(ctx.rank)
                    return None             # fleet gone mid-transfer
                time.sleep(self.transfer_pause_s)
            if tracer.enabled:
                tracer.span("state_transfer", "group", t_xfer0,
                            time.monotonic(), rank=ctx.rank,
                            bytes=snap.get("params_bytes", 0),
                            num_pages=snap.get("num_pages", 0),
                            chunks=self.transfer_chunks, reason=reason,
                            complete=True)
            epoch = ledger.request_join(ctx.rank)
            if epoch is None:
                return None                 # group finished while we warmed
            # wait (off the collective path) until the actives entered an
            # epoch that includes us; a concurrent fault may have pushed
            # the agreed epoch past our proposal, and every later epoch
            # still contains us, so we enter the newest
            while ledger.agreed_epoch < epoch:
                if ledger.stopped:
                    ledger.abandon_join(ctx.rank)
                    return None
                time.sleep(0.001)
            epoch = ledger.agreed_epoch
            comm = inst.comm_world().repair(
                ledger.members_of(epoch), ("serve-epoch", epoch))
            if tracer.enabled:
                tracer.span("replica_join", "group", t_join0,
                            time.monotonic(), rank=ctx.rank, epoch=epoch,
                            reason=reason, complete=True)
            report = RankReport(rank=ctx.rank, metrics=replica.metrics)
            report.events.append(("join", epoch, reason))
            return serve_rounds(ctx, comm, replica, tracer, report, epoch,
                                inject_faults=False)

        def rank_fn(ctx):
            if ctx.rank in actives:
                tracer = make_tracer(ctx.rank)
                inst = initialize(ctx, default_timeout=self.timeout)
                if launched == len(actives):
                    comm = inst.comm_world()
                else:
                    comm = inst.comm_world().repair(
                        tuple(sorted(actives)), ("serve-epoch", epoch0))
                if (replay_info is not None and ctx.rank == leader0
                        and tracer.enabled):
                    tracer.instant(
                        "ledger_replay", "group", rank=ctx.rank,
                        records=replay_info.records, torn=replay_info.torn,
                        epoch=epoch0, outstanding=len(ledger.replayed),
                        answered=len(replay_info.responses))
                replica = build_replica(ctx.rank, tracer)
                report = RankReport(rank=ctx.rank, metrics=replica.metrics)
                return serve_rounds(ctx, comm, replica, tracer, report,
                                    epoch0)
            # dormant spare: pre-warm at spawn, off the fleet's collective
            # path, then wait for a summons (join schedule or autoscale
            # grow) and exit quietly if the group stops first
            if ledger.stopped:
                return None
            inst = initialize(ctx, default_timeout=self.timeout)
            tracer = make_tracer(ctx.rank)
            replica = build_replica(ctx.rank, tracer)
            replica.warmup()                # clears the warm-up's events
            deadline = time.monotonic() + self.timeout * 3
            while time.monotonic() < deadline:
                if ledger.stopped:
                    ledger.abandon_join(ctx.rank)
                    return None
                if all(m in ctx.t.dead for m in ledger.members):
                    ledger.abandon_join(ctx.rank)
                    return None             # nobody left to join
                reason = ledger.summoned(ctx.rank)
                if reason is not None:
                    return join_rank(ctx, inst, tracer, replica, reason,
                                     time.monotonic())
                time.sleep(0.002)
            ledger.abandon_join(ctx.rank)
            return None

        results = run_ranks(launched, rank_fn, ulfm=True,
                            join_timeout=self.timeout * 4)
        if ledger.wal is not None:
            ledger.wal.close()
        return GroupResult(
            responses=dict(ledger.responses), reports=results,
            rerouted=tuple(ledger.rerouted), tracers=tracers,
            rebalanced=tuple(ledger.rebalanced),
            joined=tuple(ledger.joined),
            autoscale=tuple(ledger.autoscale_events),
            epoch=ledger.epoch, crashed=ledger.crashed,
            replayed=tuple(sorted(ledger.replayed)))

    # -------------------------------------------------------------- autoscaler
    def _autoscale_tick(self, ledger: GroupLedger, policy: AutoscalePolicy,
                        replica: Replica, round_i: int, report: RankReport,
                        tracer: Tracer = NULL_TRACER) -> None:
        """One leader-side policy sample. Grow and shrink both land on the
        ledger's epoch path — the same reconfiguration the fault handler
        drives — so elasticity adds no second membership mechanism."""
        st = ledger.scale_state
        members = ledger.members
        backlog = ledger.backlog()
        rem = ledger.remaining()
        hot = backlog >= policy.queue_high
        if not hot and policy.ttft_high is not None:
            p99 = replica.metrics.ttft_percentiles((99,)).get("p99")
            hot = p99 is not None and p99 > policy.ttft_high
        st["hot"] = st["hot"] + 1 if hot else 0
        st["idle"] = st["idle"] + 1 if (backlog == 0 and not hot) else 0
        since = round_i - st["last_change"]
        if (st["hot"] >= policy.grow_sustain and since >= policy.cooldown
                and len(members) < self.max_ranks):
            rank = ledger.summon_next("autoscale")
            if rank is not None:
                st["hot"] = 0
                st["last_change"] = round_i
                ledger.autoscale_events.append(
                    {"round": round_i, "action": "grow", "rank": rank})
                if tracer.enabled:
                    tracer.instant("autoscale", "group", action="grow",
                                   rank=rank, round=round_i)
                report.events.append(("autoscale", round_i, ("grow", rank)))
        elif (st["idle"] >= policy.shrink_idle and since >= policy.cooldown
                and len(members) > max(2, policy.min_ranks)
                and rem > 0 and ledger.leaving is None):
            victim = max(members)
            if victim != min(members) and ledger.request_leave(victim):
                st["idle"] = 0
                st["last_change"] = round_i
                ledger.autoscale_events.append(
                    {"round": round_i, "action": "shrink", "rank": victim})
                if tracer.enabled:
                    tracer.instant("autoscale", "group", action="shrink",
                                   rank=victim, round=round_i)
                report.events.append(
                    ("autoscale", round_i, ("shrink", victim)))
