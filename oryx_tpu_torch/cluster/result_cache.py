"""The serving cluster's exact result caches, as far as the router and
the replica construct them when both are off.

Counterpart of ``oryx_tpu/cluster/result_cache.py``, cut down to the
``from_config`` paths of its two caches: the router's ``ResultCache``
(the exact result cache and single-flight coalescing on the scatter hot
path, ``oryx.cluster.cache.enabled`` and ``oryx.cluster.coalesce.enabled``)
and the replica's ``ShardResultCache`` (``oryx.cluster.replica-cache.
enabled``, which the reference consults only from the framed transport's
dispatcher).  With every gate at its default (off) each returns None, as
the reference's does, and the router and the replica run uncached.  A
gate that is switched on raises a ``ValueError`` naming its key: the
caches are not part of this package yet.
"""

from __future__ import annotations

from ..common.config import refuse_configured

__all__ = ["ResultCache", "ShardResultCache", "ROUTER_CACHE_KEYS",
           "REPLICA_CACHE_KEYS"]

ROUTER_CACHE_KEYS = ("oryx.cluster.cache.enabled",
                     "oryx.cluster.coalesce.enabled")
REPLICA_CACHE_KEYS = ("oryx.cluster.replica-cache.enabled",)

_WHY = "the serving cluster's result caches are not part of this package yet"


class ResultCache:
    """The router's exact result cache and coalescer: absent here."""

    @classmethod
    def from_config(cls, config, metrics=None, registry=None) -> None:
        refuse_configured(config, ROUTER_CACHE_KEYS, _WHY)
        return None


class ShardResultCache:
    """The replica's exact result cache for ``/shard/*``: absent here."""

    @classmethod
    def from_config(cls, config, metrics=None) -> None:
        refuse_configured(config, REPLICA_CACHE_KEYS, _WHY)
        return None
