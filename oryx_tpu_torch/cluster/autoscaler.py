"""Gauge-driven supervisor: spawn and retire replica-group members from
the cluster's own measured signals.

Counterpart of ``oryx_tpu/cluster/autoscaler.py``.  ``python -m
oryx_tpu_torch autoscale`` polls the router's merged latency buckets,
the scatter's measured queue wait, the replicas' update-topic lag and
the router's SLO burn against ``oryx.cluster.autoscale.*`` and changes
the fleet: a breaching signal spawns one more member into the thinnest
shard's replica group; a sustained calm retires one.  Members are
ordinary ``serving --shard i/N`` processes of this package run under
:class:`~oryx_tpu_torch.resilience.policy.Supervisor`, and membership
propagates through the heartbeat protocol — the router needs no
notification.  A member serves on the autoscaler's own device: the
card unless the autoscaler was asked for the CPU (``--device cpu``),
which it passes on.

Decision discipline:

- signals must breach for ``scale-up-after`` consecutive polls, and
  stay calm for ``scale-down-after`` before a retire;
- after any action a ``cooldown-ms`` window lets the fleet settle;
- p99 is computed over the interval between polls (bucket-count
  deltas, ``obs/prom.py bucket_quantile``), never over process
  lifetime;
- scale-down retires only members this supervisor spawned, and never
  below ``min-replicas-per-shard`` live members.

The decision core (:meth:`Autoscaler.step`) is pure given a
:class:`Signals` snapshot; the HTTP polling and process spawning live
behind small seams (``fetch_json``, :class:`ReplicaLauncher`).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import urllib.request
from dataclasses import dataclass, field

from ..common import clock as clockmod
from ..obs.prom import LATENCY_BUCKETS_MS, bucket_quantile
from ..obs.slo import is_data_plane as _data_plane
from ..resilience.policy import Supervisor

_log = logging.getLogger(__name__)

__all__ = ["Signals", "AutoscalePolicy", "Autoscaler",
           "ReplicaLauncher", "ProcessReplicaLauncher", "run_autoscaler"]


@dataclass
class Signals:
    """One poll's view of the cluster (None = signal unavailable)."""
    ok: bool = False
    merged_of: int = 0
    group_sizes: dict = field(default_factory=dict)  # shard -> members
    p99_ms: float | None = None          # interval p99, data plane
    queue_wait_ms: float | None = None   # scatter's admission signal
    update_lag_records: float | None = None  # worst replica
    slo_burn_rate: float | None = None   # router's SLO engine (obs/slo)


@dataclass
class AutoscalePolicy:
    p99_high_ms: float = 500.0
    p99_low_ms: float = 50.0
    queue_wait_high_ms: float = 200.0
    update_lag_high_records: float = 0.0
    slo_burn_high: float = 0.0
    scale_up_after: int = 2
    scale_down_after: int = 12
    cooldown_sec: float = 15.0
    min_replicas_per_shard: int = 1
    max_replicas_per_shard: int = 4

    @classmethod
    def from_config(cls, config) -> "AutoscalePolicy":
        c = "oryx.cluster.autoscale"
        return cls(
            p99_high_ms=config.get_int(f"{c}.p99-high-ms"),
            p99_low_ms=config.get_int(f"{c}.p99-low-ms"),
            queue_wait_high_ms=config.get_int(f"{c}.queue-wait-high-ms"),
            update_lag_high_records=config.get_int(
                f"{c}.update-lag-high-records"),
            slo_burn_high=config.get_double(f"{c}.slo-burn-high"),
            scale_up_after=max(1, config.get_int(f"{c}.scale-up-after")),
            scale_down_after=max(
                1, config.get_int(f"{c}.scale-down-after")),
            cooldown_sec=config.get_int(f"{c}.cooldown-ms") / 1000.0,
            min_replicas_per_shard=max(1, config.get_int(
                f"{c}.min-replicas-per-shard")),
            max_replicas_per_shard=max(1, config.get_int(
                f"{c}.max-replicas-per-shard")))

    def pressure(self, s: Signals) -> list[str]:
        """Breaching scale-up signals, named for the log/status."""
        out = []
        if self.p99_high_ms > 0 and s.p99_ms is not None \
                and s.p99_ms > self.p99_high_ms:
            out.append(f"p99 {s.p99_ms:.0f}ms > {self.p99_high_ms:.0f}")
        if self.queue_wait_high_ms > 0 and s.queue_wait_ms is not None \
                and s.queue_wait_ms > self.queue_wait_high_ms:
            out.append(f"queue_wait {s.queue_wait_ms:.0f}ms > "
                       f"{self.queue_wait_high_ms:.0f}")
        if self.update_lag_high_records > 0 \
                and s.update_lag_records is not None \
                and s.update_lag_records > self.update_lag_high_records:
            out.append(f"update_lag {s.update_lag_records:.0f} > "
                       f"{self.update_lag_high_records:.0f}")
        if self.slo_burn_high > 0 and s.slo_burn_rate is not None \
                and s.slo_burn_rate > self.slo_burn_high:
            # error-budget burn (obs/slo.py): capacity is added while
            # the budget still exists, not after the SLO is blown —
            # scaling on burn rate instead of a raw latency threshold
            # is what ties the fleet size to the objective
            out.append(f"slo_burn {s.slo_burn_rate:.1f} > "
                       f"{self.slo_burn_high:.1f}")
        return out

    def calm(self, s: Signals) -> bool:
        """True when the cluster is demonstrably under-loaded (scale-
        down evidence).  p99 None (no data-plane traffic at all this
        interval) counts as calm."""
        if self.p99_low_ms <= 0:
            return False  # scale-down disabled
        if self.pressure(s):
            return False
        return s.p99_ms is None or s.p99_ms <= self.p99_low_ms


class ReplicaLauncher:
    """What the decision loop needs from the process layer.  The
    production implementation is :class:`ProcessReplicaLauncher`;
    tests substitute a fake."""

    def spawn(self, shard: int, of: int) -> str:
        raise NotImplementedError

    def retire(self, shard: int, of: int) -> str | None:
        """Stop one member of (shard, of) that THIS launcher spawned;
        None when it owns none there."""
        raise NotImplementedError

    def owned(self, of: int) -> dict[int, int]:
        """shard -> members this launcher currently runs for topology
        ``of``."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class _MemberProcess:
    """start()/await_()/close() facade over one spawned ``serving
    --shard i/N`` OS process, so the resilience Supervisor's layer
    contract applies to processes unchanged: await_ returning while
    close was never requested IS the crash signal, and the Supervisor
    rebuilds (re-spawns) with backoff."""

    def __init__(self, argv: list[str], log_path: str, env: dict):
        self._argv = argv
        self._log_path = log_path
        self._env = env
        self._proc = None
        self._closing = False

    def start(self) -> None:
        with open(self._log_path, "ab") as log:
            self._proc = subprocess.Popen(self._argv, env=self._env,
                                          stdout=log, stderr=log)

    def await_(self) -> None:
        if self._proc is not None:
            self._proc.wait()
        if not self._closing and self._proc is not None \
                and self._proc.returncode not in (0, None):
            raise RuntimeError(
                f"member exited with {self._proc.returncode}")

    def close(self) -> None:
        self._closing = True
        if self._proc is None:
            return
        # SIGINT first: the member's layer closes and the serving
        # command logs its kernel launches; terminate, then kill, if it
        # lingers
        if self._proc.poll() is None:
            self._proc.send_signal(signal.SIGINT)
        try:
            self._proc.wait(timeout=30)
            return
        except subprocess.TimeoutExpired:
            self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except Exception:  # noqa: BLE001 — escalate to kill
            self._proc.kill()


class _Member:
    __slots__ = ("member_id", "shard", "of", "supervisor", "thread")

    def __init__(self, member_id, shard, of, supervisor, thread):
        self.member_id = member_id
        self.shard = shard
        self.of = of
        self.supervisor = supervisor
        self.thread = thread


class ProcessReplicaLauncher(ReplicaLauncher):
    """Spawn supervised ``python -m oryx_tpu_torch serving --shard i/N``
    member processes.  Each member gets a derived conf — the base conf
    text with member keys appended (HOCON last-wins): cluster mode on,
    its shard spec, a stable replica id, and an ephemeral API port so
    N members coexist on one host (heartbeats advertise the real bound
    port).  ``device`` is the members' device (None means the card);
    ``"cpu"`` is passed on as ``--device cpu``."""

    def __init__(self, config, base_conf_text: str, work_dir: str,
                 python: str = sys.executable, device=None):
        self._config = config
        self._device = None if device is None else str(device)
        self._base = base_conf_text
        self._work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self._python = python
        self._members: list[_Member] = []
        self._seq = 0
        self._lock = threading.Lock()

    def _member_conf(self, member_id: str, shard: int, of: int) -> str:
        path = os.path.join(self._work_dir, f"{member_id}.conf")
        overrides = "\n".join([
            "",
            "# appended by the autoscaler (HOCON last-wins)",
            "oryx.cluster.enabled = true",
            f'oryx.cluster.shard = "{shard}/{of}"',
            f'oryx.cluster.replica-id = "{member_id}"',
            "oryx.serving.api.port = 0",
            "", ])
        with open(path, "w", encoding="utf-8") as f:
            f.write(self._base + overrides)
        return path

    def spawn(self, shard: int, of: int) -> str:
        with self._lock:
            self._seq += 1
            member_id = f"asg-{shard}of{of}-{self._seq}"
        conf = self._member_conf(member_id, shard, of)
        argv = [self._python, "-m", "oryx_tpu_torch", "serving",
                "--shard", f"{shard}/{of}", "--conf", conf]
        if self._device is not None:
            argv += ["--device", self._device]
        log_path = os.path.join(self._work_dir, f"{member_id}.log")
        # a member of this package reads no JAX setting: none is passed
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("JAX_")}

        supervisor = Supervisor.from_config(
            lambda: _MemberProcess(argv, log_path, env),
            f"autoscale-member[{member_id}]", self._config)
        thread = threading.Thread(target=self._run_supervised,
                                  args=(supervisor, member_id),
                                  daemon=True,
                                  name=f"Autoscale-{member_id}")
        member = _Member(member_id, shard, of, supervisor, thread)
        with self._lock:
            self._members.append(member)
        thread.start()
        _log.info("spawned member %s (shard %d/%d)", member_id, shard,
                  of)
        return member_id

    @staticmethod
    def _run_supervised(supervisor: Supervisor, member_id: str) -> None:
        try:
            supervisor.run()
        except Exception:  # noqa: BLE001 — restart budget exhausted
            _log.exception("member %s gave up", member_id)

    def _stop_member(self, member: _Member) -> None:
        member.supervisor.stop()
        if member.supervisor.layer is not None:
            try:
                member.supervisor.layer.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                _log.exception("closing member %s failed",
                               member.member_id)
        member.thread.join(15.0)

    def retire(self, shard: int, of: int) -> str | None:
        with self._lock:
            idx = next((i for i in range(len(self._members) - 1, -1, -1)
                        if self._members[i].shard == shard
                        and self._members[i].of == of), None)
            if idx is None:
                return None
            member = self._members.pop(idx)
        self._stop_member(member)
        _log.info("retired member %s (shard %d/%d)", member.member_id,
                  shard, of)
        return member.member_id

    def owned(self, of: int) -> dict[int, int]:
        with self._lock:
            out: dict[int, int] = {}
            for m in self._members:
                if m.of == of:
                    out[m.shard] = out.get(m.shard, 0) + 1
            return out

    def close(self) -> None:
        with self._lock:
            members, self._members = self._members, []
        for m in members:
            self._stop_member(m)


def fetch_json(url: str, timeout: float = 5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read() or b"null")


class Autoscaler:
    """Poll → decide → act.  ``step(signals, now)`` is the pure
    decision core; ``poll_signals`` is the HTTP half; ``run`` the
    loop."""

    def __init__(self, policy: AutoscalePolicy,
                 launcher: ReplicaLauncher, router_url: str,
                 poll_interval_sec: float = 5.0, metrics=None,
                 fetch=fetch_json, clock=clockmod.monotonic):
        self.policy = policy
        self.launcher = launcher
        self.router_url = router_url.rstrip("/")
        self.poll_interval_sec = poll_interval_sec
        self.metrics = metrics
        self._fetch = fetch
        self._clock = clock
        self.up_streak = 0
        self.down_streak = 0
        self.cooldown_until = 0.0
        self.actions: list[dict] = []
        # previous cumulative data-plane bucket counts (interval p99)
        self._prev_buckets: list[int] | None = None
        # counter-reset discards: a restarted process's cumulative
        # buckets went backwards, so that interval's delta is garbage
        self.counter_resets = 0

    # -- signal collection ---------------------------------------------------

    def _interval_p99(self, prom_snap: dict) -> float | None:
        """p99 over the polls' interval: data-plane bucket-count deltas
        against the previous poll (cumulative counters must not let
        history vote on current load).

        Monotonicity guard: cumulative counters only ever grow, so ANY
        per-bucket decrease means a process restarted and its counters
        reset to zero mid-interval.  Clamping each bucket at 0 (the old
        behavior) would keep the still-positive buckets and zero the
        reset ones — a partially-zeroed delta vector whose quantile is
        garbage, not conservative.  The whole interval is discarded
        (None, counted as ``autoscale_counter_resets``) and the next
        poll measures cleanly against the post-reset baseline."""
        total = [0] * (len(LATENCY_BUCKETS_MS) + 1)
        for route, r in (prom_snap.get("routes") or {}).items():
            if not _data_plane(route):
                continue
            for i, c in enumerate(
                    (r.get("latency_ms") or {}).get("buckets") or ()):
                total[i] += int(c)
        prev, self._prev_buckets = self._prev_buckets, total
        if prev is None:
            return None  # first poll: no interval yet
        if any(c < p for c, p in zip(total, prev)):
            self.counter_resets += 1
            if self.metrics is not None:
                self.metrics.inc("autoscale_counter_resets")
            _log.warning("counter reset detected (process restart?): "
                         "discarding this interval's p99")
            return None
        delta = [c - p for c, p in zip(total, prev)]
        return bucket_quantile(delta, 0.99)

    def poll_signals(self) -> Signals:
        s = Signals()
        try:
            m = self._fetch(f"{self.router_url}/metrics")
            prom = self._fetch(
                f"{self.router_url}/metrics?format=prometheus-json")
        except Exception as e:  # noqa: BLE001 — router unreachable
            _log.warning("router poll failed: %s", e)
            return s
        cluster = m.get("cluster") or {}
        membership = cluster.get("membership") or {}
        s.merged_of = int(membership.get("shards") or 0)
        groups: dict[int, int] = {sh: 0 for sh in range(s.merged_of)}
        replica_urls = []
        for r in (membership.get("replicas") or {}).values():
            if r.get("live") and r.get("ready") \
                    and int(r.get("of") or 0) == s.merged_of:
                sh = int(r.get("shard") or 0)
                groups[sh] = groups.get(sh, 0) + 1
                replica_urls.append(r.get("url"))
        s.group_sizes = groups
        qw = (cluster.get("scatter") or {}).get("cluster_queue_wait_ms")
        s.queue_wait_ms = None if qw is None else float(qw)
        # the router's SLO engine exports its worst fast-window burn as
        # a freshness gauge; absent (engine disabled) = no signal
        burn = (m.get("freshness") or {}).get("slo_burn_rate")
        s.slo_burn_rate = None if burn is None else float(burn)
        s.p99_ms = self._interval_p99(prom)
        if self.policy.update_lag_high_records > 0:
            lag = None
            for url in replica_urls:
                try:
                    rm = self._fetch(f"{url}/metrics", timeout=2.0)
                    v = (rm.get("freshness") or {}).get(
                        "update_lag_records")
                    if v is not None:
                        lag = float(v) if lag is None \
                            else max(lag, float(v))
                except Exception:  # noqa: BLE001 — replica scrape is
                    continue       # best-effort, like the router's
            s.update_lag_records = lag
        s.ok = s.merged_of >= 1
        return s

    # -- decision core -------------------------------------------------------

    def _gauges(self, s: Signals) -> None:
        if self.metrics is None:
            return
        self.metrics.set_gauge("autoscale_p99_ms",
                               -1.0 if s.p99_ms is None else
                               round(s.p99_ms, 1))
        self.metrics.set_gauge("autoscale_queue_wait_ms",
                               -1.0 if s.queue_wait_ms is None else
                               round(s.queue_wait_ms, 1))
        self.metrics.set_gauge("autoscale_update_lag_records",
                               -1.0 if s.update_lag_records is None
                               else s.update_lag_records)
        self.metrics.set_gauge("autoscale_slo_burn_rate",
                               -1.0 if s.slo_burn_rate is None
                               else round(s.slo_burn_rate, 2))
        self.metrics.set_gauge(
            "autoscale_members",
            sum(self.launcher.owned(s.merged_of).values())
            if s.merged_of else 0)

    def step(self, s: Signals, now: float | None = None) -> dict | None:
        """Advance streaks and maybe act; returns the action record
        ({kind, shard, member, reason}) or None."""
        now = self._clock() if now is None else now
        self._gauges(s)
        if not s.ok:
            # can't see the cluster: never act blind, never accrue
            # streaks from blindness
            self.up_streak = self.down_streak = 0
            return None
        if now < self.cooldown_until:
            # settling: a just-spawned member is still replaying the
            # update topic, and pressure measured before it can take
            # load must not pre-charge the next action
            self.up_streak = self.down_streak = 0
            return None
        pressure = self.policy.pressure(s)
        if pressure:
            self.up_streak += 1
            self.down_streak = 0
        elif self.policy.calm(s):
            self.down_streak += 1
            self.up_streak = 0
        else:
            self.up_streak = self.down_streak = 0
        action = None
        if self.up_streak >= self.policy.scale_up_after:
            action = self._scale_up(s, "; ".join(pressure))
        elif self.down_streak >= self.policy.scale_down_after:
            action = self._scale_down(s)
        if action is not None:
            self.cooldown_until = now + self.policy.cooldown_sec
            self.up_streak = self.down_streak = 0
            self.actions.append(action)
            _log.warning("autoscale action: %s", action)
        return action

    def _scale_up(self, s: Signals, reason: str) -> dict | None:
        # thinnest group first (HA before raw capacity), lowest shard
        # id as the deterministic tie-break
        eligible = [sh for sh in range(s.merged_of)
                    if s.group_sizes.get(sh, 0)
                    < self.policy.max_replicas_per_shard]
        if not eligible:
            _log.info("pressure (%s) but every group is at "
                      "max-replicas-per-shard", reason)
            return None
        shard = min(eligible,
                    key=lambda sh: (s.group_sizes.get(sh, 0), sh))
        member = self.launcher.spawn(shard, s.merged_of)
        return {"kind": "spawn", "shard": shard, "member": member,
                "reason": reason}

    def _scale_down(self, s: Signals) -> dict | None:
        owned = self.launcher.owned(s.merged_of)
        # retire from the fattest group, and only where the LIVE group
        # (not just our own members) stays >= the floor
        eligible = [sh for sh, n in owned.items()
                    if n > 0 and s.group_sizes.get(sh, 0)
                    > self.policy.min_replicas_per_shard]
        if not eligible:
            return None
        shard = max(eligible,
                    key=lambda sh: (s.group_sizes.get(sh, 0), -sh))
        member = self.launcher.retire(shard, s.merged_of)
        if member is None:
            return None
        return {"kind": "retire", "shard": shard, "member": member,
                "reason": f"calm x{self.policy.scale_down_after}"}

    # -- loop ----------------------------------------------------------------

    def run(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.step(self.poll_signals())
            except Exception:  # noqa: BLE001 — the supervisor must
                _log.exception("autoscale poll failed")  # outlive polls
            clockmod.wait(stop, self.poll_interval_sec)


def run_autoscaler(config, conf_path: str | None,
                   stop: threading.Event | None = None,
                   device=None) -> int:
    """The ``autoscale`` subcommand body: build the launcher from the
    operator's conf, serve the autoscaler's own gauges on the obs
    side door when configured, poll until interrupted.  ``device`` is
    the members' (None means the card)."""
    import tempfile

    from ..lambda_rt.metrics import MetricsRegistry
    from ..obs.server import ObsServer

    c = "oryx.cluster.autoscale"
    router_url = config.get_string(f"{c}.router-url")
    work_dir = config.get_optional_string(f"{c}.work-dir") \
        or tempfile.mkdtemp(prefix="oryx-autoscale-")
    base_conf = ""
    if conf_path:
        with open(conf_path, encoding="utf-8") as f:
            base_conf = f.read()
    metrics = MetricsRegistry()
    obs = ObsServer(config, metrics, tracer=None)
    obs.start()
    launcher = ProcessReplicaLauncher(config, base_conf, work_dir,
                                      device=device)
    scaler = Autoscaler(
        AutoscalePolicy.from_config(config), launcher, router_url,
        poll_interval_sec=config.get_int(
            f"{c}.poll-interval-ms") / 1000.0,
        metrics=metrics)
    stop = stop or threading.Event()
    _log.info("autoscaling %s (work dir %s)", router_url, work_dir)
    try:
        scaler.run(stop)
    except KeyboardInterrupt:
        pass
    finally:
        launcher.close()
        obs.close()
    return 0
