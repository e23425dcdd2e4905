"""A group of gloo ranks for the port's multi-rank CPU tests.

``RankGroup(world)`` starts ``world`` processes (``python
tests/_torch_ranks.py``) that join one gloo process group over a free
localhost port, each on one torch thread, and then run the cases the test
sends: ``group.run("module:function", **kwargs)`` calls the function in
every rank (modules under ``tests/`` named ``_torch_*`` that import only
torch, numpy and the port) and returns the ranks' results in rank order.
Every wait is bounded (``WAIT``); a rank's exception comes back as
``RankError`` with its traceback; ``close`` (a module fixture's finalizer)
stops the ranks and kills any that does not exit.
"""

import importlib
import os
import socket
import subprocess
import sys
import traceback
from multiprocessing.connection import Client, Listener
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WAIT = 120  # seconds any one case, start or stop may take
_KEY = b"torch-ranks"


class RankError(RuntimeError):
    pass


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class RankGroup:
    def __init__(self, world: int):
        self.world = world
        self.listener = Listener(("127.0.0.1", 0), authkey=_KEY)
        host, port = self.listener.address
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            [str(ROOT), str(ROOT / "tests")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
        env.pop("XLA_FLAGS", None)
        dist_port = free_port()
        self.procs = [
            subprocess.Popen([sys.executable, __file__, str(r), str(world), str(dist_port), str(port)],
                             env=env, cwd=str(ROOT))
            for r in range(world)
        ]
        self.conns = [None] * world
        try:
            self.listener._listener._socket.settimeout(WAIT)
            for _ in range(world):
                conn = self.listener.accept()
                self.conns[conn.recv()] = conn
            for r, conn in enumerate(self.conns):  # each rank joined the gloo group
                if not conn.poll(WAIT) or conn.recv() != "ready":
                    raise RankError(f"rank {r} did not join the process group within {WAIT} s")
        except Exception:
            self.close()
            raise

    def run(self, case: str, **kwargs):
        for conn in self.conns:
            conn.send((case, kwargs))
        out, errors = [], []
        for r, conn in enumerate(self.conns):
            if not conn.poll(WAIT):
                self.close()
                raise RankError(f"rank {r} gave no result for {case} within {WAIT} s")
            ok, value = conn.recv()
            (out if ok else errors).append(value if ok else f"rank {r}:\n{value}")
        if errors:
            raise RankError("\n".join(errors))
        return out

    def close(self):
        for conn in self.conns:
            if conn is not None:
                try:
                    conn.send(None)
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        self.listener.close()


def _main(rank: int, world: int, dist_port: int, ctl_port: int) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    conn = Client(("127.0.0.1", ctl_port), authkey=_KEY)
    conn.send(rank)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{dist_port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=WAIT))
    conn.send("ready")
    while True:
        msg = conn.recv()
        if msg is None:
            break
        case, kwargs = msg
        try:
            mod, fn = case.split(":")
            conn.send((True, getattr(importlib.import_module(mod), fn)(**kwargs)))
        except Exception:  # noqa: BLE001 (sent back to the test)
            conn.send((False, traceback.format_exc()))
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(*(int(a) for a in sys.argv[1:5]))
