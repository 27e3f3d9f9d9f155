"""Async planning service demo on the PyTorch/CUDA port: serve LM-workload
planning requests, cancel one mid-flight, and drain safely on Ctrl-C.

The twin of ``examples/serve_lm.py``, through ``repro_torch``.

Real LM graphs (a gemma3-family decoder superblock traced from the model
code, plus a transformer MLP block) are submitted as futures to
:class:`repro_torch.core.service.AsyncPlanningService`.  The sweep runs in
resumable ``hw_chunk`` slices, so a cancellation landing while the fleet
program is running is honoured at the next chunk boundary — demonstrated
here with a deliberately stalled sweep (the same duck-typed fault-hook
idiom the chaos tests use).

The whole run lives inside the service's context manager: a Ctrl-C
(KeyboardInterrupt) unwinds through ``__exit__``, which still drains the
queue — every accepted future resolves with a typed response before the
process exits, and nothing is left half-answered.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
(the default device is cuda, which raises without CUDA).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import tempfile
import time

from repro_torch.configs import resolve, scaled_down
from repro_torch.core import frontend
from repro_torch.core.arch import paper_config_space
from repro_torch.core.service import AsyncPlanningService, PlanRequest
from repro_torch.device import resolve_device


class SlowChunks:
    """Stretch each sweep chunk so the mid-flight cancel is observable.

    Any object with the right method names works as a service fault hook
    (the duck-typed idiom of repro_torch.runtime.fault_tolerance); a real
    deployment would simply omit it.
    """

    def __init__(self, stall_seconds: float = 0.05):
        self.stall_seconds = stall_seconds
        self.chunks = 0

    def before_chunk(self) -> None:
        self.chunks += 1
        time.sleep(self.stall_seconds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = scaled_down(resolve("gemma3"), window_size=16, max_seq_len=96)
    superblock = frontend.transformer_graph(cfg, seq_len=64, n_sublayers=2)
    mlp = frontend.mlp_block_graph(d_model=256, d_ff=1024, seq_len=64)

    hook = SlowChunks()
    with tempfile.TemporaryDirectory() as journal_dir, AsyncPlanningService(
        config_space=paper_config_space(),
        hw_chunk=2,  # sweep in resumable hardware-axis chunks
        journal_dir=journal_dir,  # WAL: every answer durable before publish
        backoff_seconds=0.0,
        faults=hook,
        device=dev,  # where every sweep runs
    ) as svc:
        # A request we will cancel mid-sweep, then the real workload.
        doomed = svc.submit(PlanRequest(graph=superblock))
        served = [
            svc.submit(PlanRequest(graph=g, sram_budget_words=budget))
            for g, budget in [(superblock, 2e6), (mlp, float("inf")),
                              (mlp, 1e6)]
        ]

        # Wait until the doomed request's chunked sweep is provably
        # running, then cancel: the program stops at the next chunk
        # boundary — never mid-kernel, never a silently wasted sweep.
        t0 = time.perf_counter()
        while hook.chunks == 0:
            if time.perf_counter() - t0 > 60:
                raise SystemExit("sweep never started")
            time.sleep(1e-3)
        svc.cancel(doomed)
        resp = doomed.result(timeout=300)
        print(f"[serve_lm] cancelled mid-flight after {hook.chunks} chunks "
              f"-> {resp.error_type} "
              f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        assert resp.error_type == "RequestCancelled"

        # Everything else resolves normally (a Ctrl-C here would unwind
        # through __exit__, which drains first — same guarantee).
        for fut in served:
            r = fut.result(timeout=300)
            assert r.ok, r.error_type
            hw = r.plan.best_hw
            print(f"[serve_lm] {r.plan.best_cuts.shape[0]:2d}-edge "
                  f"{'degraded' if r.degraded else 'exact':8s} plan "
                  f"via {r.engine:11s}: "
                  f"({hw.style} {hw.f1},{hw.f2},{hw.f3},{hw.f4})  "
                  f"energy {r.plan.best_metrics.energy_nj / 1e6:8.3f} mJ  "
                  f"latency {r.latency_seconds * 1e3:7.1f} ms")

        stats = svc.stats()
        print(f"[serve_lm] served {stats['counters']['completed']}, "
              f"cancelled {stats['counters']['cancelled_in_sweep']} "
              f"mid-sweep, {stats['ticks']} ticks, "
              f"journal_seq {stats['journal_seq']}")
    print("[serve_lm] drained shutdown: every accepted future resolved")


if __name__ == "__main__":
    main()
