"""oryx-lint — a concurrency-aware static analysis suite for the
oryx_tpu_torch codebase, run as ordinary tier-1 tests and as a CLI
(``python -m oryx_tpu_torch.analysis``).  It is the JAX package's
``oryx_tpu.analysis`` with the port's names: the fault seam it tracks
is ``oryx_tpu_torch.resilience.faults.fire``, the ledger is this
package's own ``suppressions.toml``, and TOML is read with the
standard library's ``tomllib``.

The last three review cycles each caught a concurrency bug by hand
that a machine should have caught: a torn topology snapshot (per-shard
reads straddling a cutover), a gauge-SLO self-deadlock on a
non-reentrant lock, and the event-loop tier where any blocking call is
a latent stall.  These passes make that class of review mechanical:

- **guarded-by** (:mod:`.guarded`) — shared-state race detector.
  ``self._x`` attributes declared guarded (a ``# guarded-by: _lock``
  trailing annotation on the ``__init__`` assignment) or *inferred*
  guarded (ever mutated inside ``with self._lock:`` outside
  ``__init__``) must have every mutation and compound
  read-modify-write lexically under that lock, or inside a method
  whose name ends in ``_locked`` (the caller-holds-the-lock
  convention ``membership._ranked_locked`` established).
- **async-blocking** (:mod:`.async_blocking`) — event-loop lint.
  Inside any ``async def`` (and the same-module sync helpers it
  calls), flag ``time.sleep``, blocking socket/file I/O,
  ``subprocess``, bare ``Lock.acquire()``/``Event.wait()``, and a
  deny-list of known-blocking framework calls — unless the call is
  wrapped in ``run_in_executor``/the bridge.
- **lock-order** (:mod:`.lock_order`) — deadlock-cycle detector.
  Builds the static acquired-while-holding graph from nested ``with``
  blocks, resolvable calls, and the ``_locked`` convention, across
  modules; any cycle (including a non-reentrant self-cycle, the
  slo.py deadlock class) fails.
- **drift** (:mod:`.drift`) — config/chaos cross-surface checks.
  Every ``oryx.*`` key read in code exists in
  ``common/reference.conf`` and vice versa; every chaos fault point
  fired via ``resilience/faults`` has a ``docs/RESILIENCE.md`` table
  row and vice versa.

False positives go in the checked-in suppression ledger
(``oryx_tpu_torch/analysis/suppressions.toml``); every entry requires
a one-line justification and must still match a live finding — both
enforced by ``tests/test_torch_static_analysis.py``.  docs/ANALYSIS.md is
the operator manual (annotation grammar, ledger format, runbook).
"""

from __future__ import annotations

from .core import (Finding, SourceModel, Suppression, load_suppressions,
                   apply_suppressions, run_passes, PASS_NAMES)

__all__ = ["Finding", "SourceModel", "Suppression", "load_suppressions",
           "apply_suppressions", "run_passes", "PASS_NAMES"]
