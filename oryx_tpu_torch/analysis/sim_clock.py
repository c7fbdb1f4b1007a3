"""sim-clock — virtual-clock seam lint.

The deterministic cluster simulation (``oryx_tpu_torch/sim/``) can only
control time it can see.  Production modules the sim stands up in
one process must route every time read, sleep, and event wait through
the clock seam (``oryx_tpu_torch/common/clock.py``) — a direct
``time.monotonic()`` in a sim-covered module is wall time leaking
into a simulated world: TTLs that never expire under virtual time,
staleness gauges that read real seconds, waits that actually block
the single sim process.

Rules, applied only to modules under the sim-covered prefixes
(``COVERED``):

- ``direct-time`` — a call to ``time.time`` / ``time.monotonic`` /
  ``time.sleep`` / ``time.perf_counter`` (and the ``_ns`` variants),
  resolved through import aliases.  Route it through
  ``clockmod.now()`` / ``clockmod.monotonic()`` / ``clockmod.sleep()``
  or an injected per-instance clock.
- ``event-wait`` — a ``.wait(...)`` method call whose receiver is not
  the clock seam itself.  A raw ``Event.wait(timeout)`` burns real
  seconds the virtual clock cannot advance past; use
  ``clockmod.wait(event, timeout)`` or ``self._clock.wait(...)``.

Escapes:

- a trailing ``# wall-clock: <why>`` comment on the flagged line —
  for waits that are genuinely about the real world (a Condition
  poll on a real thread, a child-process reap);
- a ledger entry in ``analysis/suppressions.toml`` (pass
  ``sim-clock``), stale-checked like every other pass.

Receivers named ``clock`` / ``clockmod`` / ``*._clock`` / ``*.clock``
are the seam and are never flagged.
"""

from __future__ import annotations

import ast

from .core import Finding, ModuleSource, SourceModel

__all__ = ["run", "COVERED", "TIME_CALLS"]

PASS = "sim-clock"

# directory-boundary fragments of the module paths the sim stands up
# in-process and therefore must be virtual-time clean (matched
# against ModuleSource.rel at a "/" boundary, so the seeded-defect
# fixture tree under tests/fixtures/analysis/cluster/ is covered by
# the same rule as oryx_tpu_torch/cluster/)
COVERED = (
    "cluster/",
    "resilience/",
    "serving/",
    "obs/",
    "kafka/inproc.py",
)

# direct wall-time calls (resolved through import aliases)
TIME_CALLS = {
    "time.time": "clockmod.now()",
    "time.monotonic": "clockmod.monotonic()",
    "time.sleep": "clockmod.sleep()",
    "time.perf_counter": "clockmod.monotonic()",
    "time.time_ns": "clockmod.now()",
    "time.monotonic_ns": "clockmod.monotonic()",
}

# receiver names that ARE the seam: clock.wait / clockmod.wait /
# self._clock.wait / cx.clock.wait never get flagged
_SEAM_NAMES = {"clock", "clockmod", "_clock"}


def _covered(mod: ModuleSource) -> bool:
    rel = "/" + mod.rel
    return any("/" + p in rel for p in COVERED)


def _receiver_text(func: ast.Attribute) -> str:
    """Dotted source text of a ``.wait`` call's full receiver chain,
    e.g. ``self._proc.wait`` — the stable suppression symbol."""
    parts = [func.attr]
    node = func.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    parts.append(node.id if isinstance(node, ast.Name) else "?")
    return ".".join(reversed(parts))


def _is_seam_receiver(func: ast.Attribute) -> bool:
    node = func.value
    if isinstance(node, ast.Attribute):
        return node.attr in _SEAM_NAMES
    if isinstance(node, ast.Name):
        return node.id in _SEAM_NAMES
    return False


def run(model: SourceModel) -> list[Finding]:
    findings: list[Finding] = []
    for mod in model.modules:
        if not _covered(mod):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            note = mod.trailing_comment(node.lineno)
            if note.startswith("wall-clock:"):
                continue
            dotted = mod.dotted_call_name(node.func)
            if dotted in TIME_CALLS:
                findings.append(Finding(
                    PASS, "direct-time", mod.rel, node.lineno, dotted,
                    f"direct {dotted}() in a sim-covered module — "
                    f"wall time leaks into the simulated world; use "
                    f"{TIME_CALLS[dotted]} or an injected clock"))
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "wait"
                    and not _is_seam_receiver(node.func)):
                symbol = _receiver_text(node.func)
                findings.append(Finding(
                    PASS, "event-wait", mod.rel, node.lineno, symbol,
                    f"{symbol}(...) bypasses the clock seam — a raw "
                    f"wait blocks on real seconds the virtual clock "
                    f"cannot advance past; use clockmod.wait(event, "
                    f"timeout) or annotate '# wall-clock: <why>'"))
    return findings
