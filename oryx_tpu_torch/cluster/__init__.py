"""The horizontally-sharded serving cluster: each replica holds 1/N of
the item catalog (and the whole user store), and the router merges the
replicas' exact local top-k into the exact global top-N.

Counterpart of ``oryx_tpu/cluster/`` without the region mirror and the
autoscaler:

- :mod:`.sharding` — the stable item-id -> shard hash (the Kafka
  partitioner contract, kafka/partitioner.py).
- :mod:`.membership` — replica heartbeats on the update topic (``HB``
  key) and the router's live, generation-aware registry.
- :mod:`.shard_resources` — the replica-internal ``/shard/*`` routes.
- :mod:`.merge` — the exact merge and the canonical tie-break.
- :mod:`.scatter` — deadline-propagating, hedging, circuit-broken
  fan-out over the framed transport or an HTTP/1.1 socket pool (TLS and
  DIGEST included).
- :mod:`.transport` — the multiplexed framed router-to-replica hop.
- :mod:`.admission` — measured-queue-wait admission control.
- :mod:`.result_cache` — the router's exact result cache with
  single-flight coalescing, and the replica's shard cache.
- :mod:`.async_http` — the router's asyncio front end.
- :mod:`.router` — the gateway layer.

Run a two-shard cluster on one host (each node with its own port)::

    python -m oryx_tpu_torch serving --shard 0/2 --conf node0.conf &
    python -m oryx_tpu_torch serving --shard 1/2 --conf node1.conf &
    python -m oryx_tpu_torch router --conf router.conf &
"""
