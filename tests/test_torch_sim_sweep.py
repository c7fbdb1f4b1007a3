"""Seed sweeps and the pinned seed corpus, on the port's simulation
(``oryx_tpu_torch.sim``).

Each scenario runs 200 seeded interleavings inside the wall-clock
budget the JAX package's sweep holds (tests/test_sim_sweep.py), and a
sample of the sweep replays its trace hashes.  Every (scenario, seed)
of the pinned corpus tests/fixtures/sim_seeds.toml, seeds that once
exposed a real bug, runs twice with equal hashes, and both equal the
reference simulation's hash for that seed.  The corpus is read with
the standard library's ``tomllib``.
"""

from __future__ import annotations

import os
import time
import tomllib

import pytest

from oryx_tpu.sim import run_scenario as ref_run_scenario
from oryx_tpu_torch.sim import SimFailure, run_scenario

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "sim_seeds.toml")

# the reference's sweep shape and budgets (about 4x a seed's cost)
_SWEEP_SEEDS = 200
_BUDGETS_SEC = {"mirror-partition": 120.0, "reshard-cutover": 90.0,
                "speed-shard-crash": 60.0, "ingest-overload": 60.0,
                "slo-page-flight": 90.0}
# seeds re-run after each sweep to check trace-hash reproducibility
_REPLAY_SAMPLE = (0, 67, 133, 199)


def _corpus() -> list[dict]:
    with open(_FIXTURE, "rb") as fh:
        return tomllib.load(fh)["seed"]


def _corpus_ids() -> list[str]:
    return [f"{e['scenario']}-{e['seed']}" for e in _corpus()]


@pytest.mark.parametrize("entry", _corpus(), ids=_corpus_ids())
def test_seed_regression_corpus(entry):
    """Replay each pinned seed twice: the invariants hold, the two
    trace hashes are byte-identical, and they are the reference's."""
    first = run_scenario(entry["scenario"], entry["seed"])
    second = run_scenario(entry["scenario"], entry["seed"])
    assert first.trace_hash == second.trace_hash, (
        f"nondeterministic replay of pinned seed {entry['seed']} "
        f"({entry['scenario']}): {first.trace_hash[:16]} != "
        f"{second.trace_hash[:16]}")
    assert first.steps == second.steps
    ref = ref_run_scenario(entry["scenario"], entry["seed"])
    assert (first.trace_hash, first.steps, first.virtual_sec) \
        == (ref.trace_hash, ref.steps, ref.virtual_sec)


def _sweep(scenario: str, seeds) -> dict[int, str]:
    hashes: dict[int, str] = {}
    for seed in seeds:
        try:
            hashes[seed] = run_scenario(scenario, seed).trace_hash
        except SimFailure as e:
            # the message is the bug report: invariant, seed, trace
            # hash and the one-line repro command
            pytest.fail(str(e), pytrace=False)
    return hashes


@pytest.mark.parametrize("scenario", sorted(_BUDGETS_SEC))
def test_sweep_200_interleavings(scenario):
    """200 seeded interleavings, all invariants green, inside the
    reference's wall-clock budget; then a sampled replay reproduces
    the sweep's trace hashes."""
    t0 = time.perf_counter()
    hashes = _sweep(scenario, range(_SWEEP_SEEDS))
    took = time.perf_counter() - t0
    budget = _BUDGETS_SEC[scenario]
    assert took < budget, (
        f"{scenario} sweep of {_SWEEP_SEEDS} seeds took {took:.1f}s "
        f"(budget {budget:.0f}s) — the simulation got too slow for "
        f"tier-1")
    assert len(hashes) == _SWEEP_SEEDS
    for seed in _REPLAY_SAMPLE:
        assert run_scenario(scenario, seed).trace_hash \
            == hashes[seed], f"seed {seed} did not replay its trace"
