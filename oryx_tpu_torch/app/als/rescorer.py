"""ALS result rescoring plugin API.

Counterpart of ``oryx_tpu/app/als/rescorer.py`` (reference:
RescorerProvider.java:48 — the per-endpoint hooks, Rescorer.java:24 —
rescore/isFiltered, MultiRescorer.java and MultiRescorerProvider.java:30
— composition, loaded from comma-separated class names as
ALSServingModelManager.loadRescorerProviders does, :120-137).

A provider is user code, so ``load_rescorer_providers`` takes any
importable class path, except one of the JAX package ``oryx_tpu``: its
providers build the JAX package's rescorers, which this package does not
run.
"""

from __future__ import annotations

import abc
import importlib
from typing import Sequence

__all__ = ["Rescorer", "RescorerProvider", "MultiRescorer",
           "MultiRescorerProvider", "load_rescorer_providers"]

# the JAX package, whose classes a provider path must not name
_JAX_PACKAGE = "oryx_tpu"


class Rescorer(abc.ABC):
    """Transforms scores of candidate results, or filters them out."""

    @abc.abstractmethod
    def rescore(self, item_id: str, score: float) -> float: ...

    def is_filtered(self, item_id: str) -> bool:
        return False


class RescorerProvider(abc.ABC):
    """Supplies Rescorers per serving endpoint; any hook may return None
    meaning 'no rescoring'."""

    def get_recommend_rescorer(self, user_id: str,
                               args: Sequence[str]) -> Rescorer | None:
        return None

    def get_recommend_to_anonymous_rescorer(
            self, item_ids: Sequence[str],
            args: Sequence[str]) -> Rescorer | None:
        return None

    def get_most_popular_items_rescorer(
            self, args: Sequence[str]) -> Rescorer | None:
        return None

    def get_most_active_users_rescorer(
            self, args: Sequence[str]) -> Rescorer | None:
        return None

    def get_most_similar_items_rescorer(
            self, args: Sequence[str]) -> Rescorer | None:
        return None


class MultiRescorer(Rescorer):
    """Applies several Rescorers in sequence (reference:
    MultiRescorer.java)."""

    def __init__(self, rescorers: Sequence[Rescorer]):
        self._rescorers = list(rescorers)

    def rescore(self, item_id: str, score: float) -> float:
        for r in self._rescorers:
            score = r.rescore(item_id, score)
            if score != score:  # NaN filters
                return score
        return score

    def is_filtered(self, item_id: str) -> bool:
        return any(r.is_filtered(item_id) for r in self._rescorers)


def _combine(rescorers: list[Rescorer | None]) -> Rescorer | None:
    present = [r for r in rescorers if r is not None]
    if not present:
        return None
    if len(present) == 1:
        return present[0]
    return MultiRescorer(present)


class MultiRescorerProvider(RescorerProvider):
    """Composes several providers (reference:
    MultiRescorerProvider.java:30)."""

    def __init__(self, providers: Sequence[RescorerProvider]):
        self._providers = list(providers)

    def get_recommend_rescorer(self, user_id, args):
        return _combine([p.get_recommend_rescorer(user_id, args)
                         for p in self._providers])

    def get_recommend_to_anonymous_rescorer(self, item_ids, args):
        return _combine([p.get_recommend_to_anonymous_rescorer(item_ids, args)
                         for p in self._providers])

    def get_most_popular_items_rescorer(self, args):
        return _combine([p.get_most_popular_items_rescorer(args)
                         for p in self._providers])

    def get_most_active_users_rescorer(self, args):
        return _combine([p.get_most_active_users_rescorer(args)
                         for p in self._providers])

    def get_most_similar_items_rescorer(self, args):
        return _combine([p.get_most_similar_items_rescorer(args)
                         for p in self._providers])


def _load_provider(name: str) -> RescorerProvider:
    """Instantiate one provider class by its ``pkg.module.Class`` path;
    a path that does not load, or names the JAX package, raises
    ``ValueError``."""
    module_name, _, cls_name = name.rpartition(".")
    if not module_name:
        raise ValueError(f"rescorer provider {name!r} is not a qualified "
                         f"class name")
    if module_name.split(".")[0] == _JAX_PACKAGE:
        raise ValueError(
            f"rescorer provider {name!r} is a class of the JAX package "
            f"{_JAX_PACKAGE}, which this package does not load: write the "
            f"provider against oryx_tpu_torch.app.als.rescorer")
    try:
        cls = getattr(importlib.import_module(module_name), cls_name)
    except (ImportError, AttributeError) as e:
        raise ValueError(f"rescorer provider {name!r} does not load: "
                         f"{e}") from e
    return cls()


def load_rescorer_providers(class_names: str | None
                            ) -> RescorerProvider | None:
    """Instantiate provider(s) from comma-separated class paths
    (reference: ALSServingModelManager.loadRescorerProviders); several
    compose into a MultiRescorerProvider."""
    if not class_names:
        return None
    providers = [_load_provider(name.strip())
                 for name in class_names.split(",") if name.strip()]
    if not providers:
        return None
    if len(providers) == 1:
        return providers[0]
    return MultiRescorerProvider(providers)
