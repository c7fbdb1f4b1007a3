"""Operator CLI: run layers and manage topics.

Counterpart of ``oryx_tpu/deploy/main.py`` (reference:
deploy/bin/oryx-run.sh:24-33 — subcommands batch | speed | serving |
kafka-setup | kafka-tail | kafka-input, a ``--conf`` file overlaid on
the built-in defaults — and the three Main classes: construct the layer
from config, register a shutdown hook, start, await).  ``warmup``
builds and loads the kernel libraries before traffic
(deploy/warmup.py), ``config-to-properties`` prints the resolved
configuration, ``serving --shard i/N`` starts a serving-cluster replica
of catalog shard ``i`` of ``N``, and ``router`` the cluster's
scatter-gather gateway (cluster/router.py).  ``speed --shard`` passes
the reference's overlay to the speed layer, which refuses it by key
until the sharded speed layer is part of this package, and ``router
--async`` serves the router's public door on the asyncio front end
(``oryx.cluster.async.enabled``, cluster/async_http.py).

One flag the reference does not have: ``--device`` on ``batch``,
``speed``, ``serving``, ``router`` and ``warmup``.  Its default is the
CUDA card; ``--device cpu`` runs on the host when asked.  ``autoscale``
and ``mirror`` are listed so that ``--help`` shows the reference's
surface, and each exits non-zero at once, by name.

Usage:
    python -m oryx_tpu_torch <subcommand> [--conf my.conf] ...
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from ..common.config import Config, from_dict, from_file, get_default
from ..common.lang import ShutdownHook

__all__ = ["main", "UNPORTED_COMMANDS"]

_log = logging.getLogger(__name__)

# the reference's subcommands whose layers this package does not have
# yet: each refuses by name
UNPORTED_COMMANDS = {
    "autoscale": "the gauge-driven replica autoscaler",
    "mirror": "the cross-region update-topic mirror",
}


def _load_config(conf: str | None) -> Config:
    return from_file(conf) if conf else get_default()


def _run_layer(make_layer, name: str, config: Config) -> None:
    """Run a layer to completion.  With ``oryx.resilience.supervisor.
    enabled`` (the default) a layer whose worker thread dies is rebuilt
    and restarted with backoff.  The first layer is built before the
    supervisor starts, so a configuration the layer refuses fails at
    once instead of after the restart budget."""
    from ..resilience.policy import Supervisor
    hook = ShutdownHook()
    first = [make_layer()]
    if config.get_bool("oryx.resilience.supervisor.enabled"):
        def factory():
            return first.pop() if first else make_layer()

        supervisor = Supervisor.from_config(factory, name, config)

        class _Stop:  # close() halts the supervisor loop and the
            def close(self):  # current layer, for the shutdown hook
                supervisor.stop()
                if supervisor.layer is not None:
                    supervisor.layer.close()

        hook.add_close_at_shutdown(_Stop())
        supervisor.run()
        return
    layer = first.pop()
    hook.add_close_at_shutdown(layer)
    layer.start()
    try:
        layer.await_()
    except KeyboardInterrupt:
        pass
    finally:
        layer.close()


def _shard_overlay(config: Config, shard: str | None, keys) -> Config:
    """``config`` with ``shard`` set at ``keys`` (the reference's
    overlay); a malformed spec fails here."""
    if not shard:
        return config
    from ..cluster.sharding import parse_shard_spec
    parse_shard_spec(shard)
    return from_dict({k: (True if k.endswith(".enabled") else shard)
                      for k in keys}, config)


def _cmd_batch(args) -> int:
    from ..lambda_rt.batch import BatchLayer
    config = _load_config(args.conf)
    _run_layer(lambda: BatchLayer(config, device=args.device), "batch",
               config)
    return 0


def _cmd_speed(args) -> int:
    from ..lambda_rt.speed import SpeedLayer
    config = _shard_overlay(_load_config(args.conf), args.shard,
                            ("oryx.speed.shard",))
    _run_layer(lambda: SpeedLayer(config, device=args.device), "speed",
               config)
    return 0


def _cmd_serving(args) -> int:
    from ..lambda_rt.serving import ServingLayer
    from ..ops import launches
    config = _shard_overlay(_load_config(args.conf), args.shard,
                            ("oryx.cluster.enabled", "oryx.cluster.shard"))
    _run_layer(lambda: ServingLayer(config, device=args.device), "serving",
               config)
    # which hand-written kernels served this process
    _log.info("serving: kernel launches=%s", json.dumps(launches.counts()))
    return 0


def _cmd_router(args) -> int:
    """The scatter-gather gateway: the public REST front end over a
    fleet of shard replicas (cluster/router.py).  ``--async`` sets
    ``oryx.cluster.async.enabled``: the public door runs on the asyncio
    front end (cluster/async_http.py)."""
    from ..cluster.router import RouterLayer
    config = _load_config(args.conf)
    if args.async_mode is not None:
        config = from_dict({"oryx.cluster.async.enabled":
                            bool(args.async_mode)}, config)
    _run_layer(lambda: RouterLayer(config, device=args.device), "router",
               config)
    return 0


def _cmd_unported(args) -> int:
    print(f"oryx_tpu_torch: {args.command}: {UNPORTED_COMMANDS[args.command]}"
          f" is not part of this package yet", file=sys.stderr)
    return 2


def _topic_config(config: Config) -> list[tuple[str, str]]:
    return [
        (config.get_string("oryx.input-topic.broker"),
         config.get_string("oryx.input-topic.message.topic")),
        (config.get_string("oryx.update-topic.broker"),
         config.get_string("oryx.update-topic.message.topic")),
    ]


def _cmd_kafka_setup(args) -> int:
    from ..kafka import utils as kafka_utils
    config = _load_config(args.conf)
    # reference oryx-run.sh:343,356 — the input topic with 4 partitions,
    # the update topic with 1 (total order for MODEL/UP replay)
    partitions = [kafka_utils.input_topic_partitions(config), 1]
    for (broker, topic), n in zip(_topic_config(config), partitions):
        kafka_utils.maybe_create_topic(broker, topic, partitions=n)
        exists = kafka_utils.topic_exists(broker, topic)
        print(f"{topic} @ {broker}: {'exists' if exists else 'missing'}")
    return 0


def _cmd_kafka_tail(args) -> int:
    from ..kafka.inproc import resolve_broker
    config = _load_config(args.conf)
    consumers = [(topic, resolve_broker(broker))
                 for broker, topic in _topic_config(config)]
    print("Tailing input and update topics; Ctrl-C to stop", file=sys.stderr)
    try:
        offsets = {topic: [0] * broker.num_partitions(topic)
                   for topic, broker in consumers}
        while True:
            idle = True
            for topic, broker in consumers:
                ends = broker.latest_offsets(topic)
                for km in broker.read_ranges(topic, offsets[topic], ends):
                    print(f"{topic}\t{km.key}\t{km.message}")
                    idle = False
                offsets[topic] = ends
            if args.once and idle:
                return 0
            if idle:
                time.sleep(0.5)
    except KeyboardInterrupt:
        return 0


def _cmd_kafka_input(args) -> int:
    from ..kafka.inproc import resolve_broker
    config = _load_config(args.conf)
    topic = config.get_string("oryx.input-topic.message.topic")
    broker = resolve_broker(config.get_string("oryx.input-topic.broker"))
    n = 0
    source = open(args.file, encoding="utf-8") if args.file else sys.stdin
    try:
        for line in source:
            line = line.rstrip("\n")
            if line:
                broker.send(topic, None, line)
                n += 1
    finally:
        if args.file:
            source.close()
    print(f"Sent {n} lines to {topic}", file=sys.stderr)
    return 0


def _cmd_warmup(args) -> int:
    """Build and load every kernel library the serving dispatch can
    route to on the shape ladder (and optionally run one training
    iteration), into ``oryx.compile-cache-dir``, so that the first layer
    start on this machine loads libraries instead of running ``nvcc``
    (deploy/warmup.py)."""
    from .warmup import run_warmup
    config = _load_config(args.conf)
    items_list = [round(float(x) * 1e6) if "." in x or float(x) < 1000
                  else int(x) for x in args.items.split(",") if x]
    # the default dtype is the deployment's: it picks the store kernel's
    # body the layers will run
    dtypes = [d.strip() for d in args.dtypes.split(",") if d.strip()] \
        if args.dtypes else [config.get_string("oryx.als.factor-dtype")]
    report = run_warmup(
        config,
        items_list=items_list,
        features_list=[int(x) for x in args.features.split(",") if x],
        dtypes=dtypes,
        how_many=args.how_many,
        train_ratings=args.train_ratings,
        train_rank=args.train_rank,
        device=args.device)
    print(json.dumps(report if args.verbose else {
        k: v for k, v in report.items() if k not in ("compiled", "plain")}))
    return 1 if report["compiled_count"] == 0 else 0


def _cmd_config_to_properties(args) -> int:
    """Print the resolved ``oryx.*`` configuration as sorted
    ``key=value`` .properties lines (reference:
    ConfigToProperties.java:29-58, used by oryx-run.sh:87)."""
    props = _load_config(args.conf).to_properties()
    for k in sorted(props):
        if k == "oryx" or k.startswith("oryx."):
            print(f"{k}={props[k]}")
    return 0


_COMMANDS = [
    ("batch", _cmd_batch, "run the batch (training) layer"),
    ("speed", _cmd_speed, "run the speed (incremental) layer"),
    ("serving", _cmd_serving, "run the serving (REST) layer"),
    ("router", _cmd_router,
     "run the cluster gateway: scatter-gather router over sharded "
     "serving replicas (see serving --shard)"),
    ("autoscale", _cmd_unported,
     "not part of this package yet: " + UNPORTED_COMMANDS["autoscale"]),
    ("mirror", _cmd_unported,
     "not part of this package yet: " + UNPORTED_COMMANDS["mirror"]),
    ("kafka-setup", _cmd_kafka_setup, "create/check topics"),
    ("kafka-tail", _cmd_kafka_tail, "print topic traffic"),
    ("kafka-input", _cmd_kafka_input, "send lines to input topic"),
    ("warmup", _cmd_warmup,
     "build and load the kernel libraries of the serving ladder into "
     "oryx.compile-cache-dir (install time: the first start then runs "
     "no nvcc)"),
    ("config-to-properties", _cmd_config_to_properties,
     "print resolved oryx.* config as key=value lines"),
]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="oryx_tpu_torch",
        description="lambda-architecture ML framework on an NVIDIA GPU")
    parser.add_argument("--log-level", default="INFO")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, fn, help_ in _COMMANDS:
        p = sub.add_parser(name, help=help_)
        p.add_argument("--conf", help="HOCON config file overlaying defaults")
        p.set_defaults(fn=fn)
        if name in ("batch", "speed", "serving", "router", "warmup"):
            p.add_argument("--device", default=None,
                           help="torch device (default: the CUDA card; "
                                "'cpu' runs on the host)")
        if name == "router":
            p.add_argument("--async", dest="async_mode",
                           action=argparse.BooleanOptionalAction,
                           default=None,
                           help="serve the public door on the asyncio "
                                "front end (oryx.cluster.async.enabled)")
        if name == "speed":
            p.add_argument("--shard", default=None, metavar="i/N",
                           help="fold in only item slice i of N "
                                "(oryx.speed.shard)")
        if name == "serving":
            p.add_argument("--shard", default=None, metavar="i/N",
                           help="serve catalog shard i of N as a cluster "
                                "replica (oryx.cluster.shard)")
        if name == "kafka-tail":
            p.add_argument("--once", action="store_true",
                           help="drain current contents and exit")
        if name == "kafka-input":
            p.add_argument("--file", help="read lines from a file "
                                          "instead of stdin")
        if name == "warmup":
            p.add_argument("--items", default="1,5,20",
                           help="comma list of item counts; values under "
                                "1000 mean millions (default the "
                                "published envelope 1,5,20)")
            p.add_argument("--features", default="50,250",
                           help="comma list of feature ranks")
            p.add_argument("--dtypes", default=None,
                           help="comma list of factor dtypes to warm "
                                "(default: the config's "
                                "oryx.als.factor-dtype)")
            p.add_argument("--how-many", type=int, default=10)
            p.add_argument("--train-ratings", type=int, default=0,
                           help="also run one real training iteration at "
                                "this rating count")
            p.add_argument("--train-rank", type=int, default=0)
            p.add_argument("--verbose", action="store_true",
                           help="include the full per-kernel lists in the "
                                "report")

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
