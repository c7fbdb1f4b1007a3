"""Two processes join one ``torch.distributed`` group over gloo through
``initialize_multihost`` (the ``oryx.distributed.*`` keys), each holding
4 CPU entries of an 8-entry mesh, and run one ring step of
``train_als_distributed`` (the ring is ``mode="auto"``'s choice when the
mesh spans processes).  Both report the same checksum, equal to that of
an 8-entry run in one process: the ring's shift and the final gather
really crossed the process boundary.  The counterpart of
``tests/test_multihost_it.py`` (the reference's two-process join)."""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMEOUT_SEC = 120
_ENTRIES = 4  # per process

_CHILD = textwrap.dedent("""
    import hashlib, json, sys
    import numpy as np
    from oryx_tpu_torch.common.config import from_dict
    from oryx_tpu_torch.parallel.mesh import Mesh, initialize_multihost
    from oryx_tpu_torch.parallel import train_als_distributed
    from tests.test_torch_multiprocess import ratings

    coord, pid, entries = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    assert initialize_multihost(from_dict({
        "oryx.distributed.coordinator-address": coord,
        "oryx.distributed.num-processes": 2,
        "oryx.distributed.process-id": pid}), device="cpu")
    # a second call is a no-op on a joined process
    assert initialize_multihost(from_dict({
        "oryx.distributed.coordinator-address": coord,
        "oryx.distributed.num-processes": 2,
        "oryx.distributed.process-id": pid}), device="cpu")
    import torch.distributed as dist
    mesh = Mesh(["cpu"] * entries, group=dist.group.WORLD)
    model = train_als_distributed(ratings(), 5, 0.01, 1.0, True, 1, mesh,
                                  seed=3)
    digest = hashlib.sha256(model.X.tobytes() + model.Y.tobytes())
    print("MULTIPROCESS_OK", json.dumps({
        "process": dist.get_rank(), "entries": mesh.size,
        "checksum": digest.hexdigest()}))
    dist.destroy_process_group()
""")


def ratings():
    from oryx_tpu_torch.app.als.common import ParsedRatings
    rng = np.random.default_rng(17)
    pairs = sorted({(int(rng.integers(37)), int(rng.integers(29)))
                    for _ in range(300)})
    users, items = np.array(pairs, dtype=np.int32).T
    vals = rng.uniform(0.5, 3.0, len(users)).astype(np.float32)
    return ParsedRatings([f"u{i}" for i in range(37)],
                         [f"i{i}" for i in range(29)], users, items, vals)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_train_one_ring_step():
    from oryx_tpu_torch.parallel import train_als_distributed
    from oryx_tpu_torch.parallel.mesh import Mesh

    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, coord, str(pid), str(_ENTRIES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=_TIMEOUT_SEC)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    payloads = []
    for rc, out, err in outs:
        assert rc == 0, f"child failed rc={rc}\n{out}\n{err[-3000:]}"
        payloads.append(json.loads(out.split("MULTIPROCESS_OK", 1)[1]))
    assert {p["process"] for p in payloads} == {0, 1}
    assert all(p["entries"] == 2 * _ENTRIES for p in payloads)
    assert payloads[0]["checksum"] == payloads[1]["checksum"]

    one = train_als_distributed(ratings(), 5, 0.01, 1.0, True, 1,
                                Mesh(["cpu"] * (2 * _ENTRIES)), seed=3,
                                mode="ring")
    digest = hashlib.sha256(one.X.tobytes() + one.Y.tobytes())
    assert payloads[0]["checksum"] == digest.hexdigest()
