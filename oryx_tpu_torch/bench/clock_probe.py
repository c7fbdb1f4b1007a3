"""The card's SM clock and power while ``phase_a`` runs back to back.

Run from the repository root on a machine with one NVIDIA card:

    python3 -m oryx_tpu_torch.bench.clock_probe

For each head case of ``phase_a`` (5,111,808 x 256 store; float32 at 8
and 256 queries, bfloat16 at 256) it launches the kernel for four
seconds, samples ``nvidia-smi`` every 0.2 s meanwhile, and prints one
JSON line: the mean time per call over the loop and the samples' SM
clock, power draw and power limit.  A short burst timed by chip_smoke.py
and a sustained loop may differ when the card reaches its power limit.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time

ROWS = 5_111_808
WIDTH = 256
SECONDS = 4.0
QUERY = "clocks.sm,clocks.max.sm,power.draw,power.limit"


def _sample(stop: threading.Event, out: list) -> None:
    while not stop.is_set():
        out.append(subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip())
        time.sleep(0.2)


def main() -> int:
    import torch
    from oryx_tpu_torch.ops import phase_a as pa
    if not torch.cuda.is_available():
        print("clock_probe: no CUDA device")
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    Y32 = torch.randn(ROWS, WIDTH, device="cuda", generator=gen)
    pen = torch.zeros(ROWS // pa.BLOCK_ROWS, pa.BLOCK_ROWS, device="cuda")
    for dtype, b in ((torch.float32, 8), (torch.float32, 256),
                     (torch.bfloat16, 256)):
        Y = Y32.to(dtype)
        Q = torch.randn(b, WIDTH, device="cuda", generator=gen).to(dtype)
        for _ in range(3):
            pa.phase_a(Q, Y, pen)
        torch.cuda.synchronize()
        samples: list = []
        stop = threading.Event()
        thread = threading.Thread(target=_sample, args=(stop, samples))
        thread.start()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        calls, t0 = 0, time.perf_counter()
        e0.record()
        while time.perf_counter() - t0 < SECONDS:
            for _ in range(10):
                pa.phase_a(Q, Y, pen)
            torch.cuda.synchronize()
            calls += 10
        e1.record()
        e1.synchronize()
        stop.set()
        thread.join()
        # the first samples fall before the card reaches its steady state
        print(json.dumps({"store": str(dtype).split(".")[-1], "B": b,
                          "rows": ROWS, "width": WIDTH,
                          "ms_mean": e0.elapsed_time(e1) / calls,
                          "calls": calls, QUERY: samples[2:]}), flush=True)
        del Y
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
