"""What a torch world does once the store it was formed from is gone.

The port's tracker hosts each epoch's rendezvous store (a
``torch.distributed.TCPStore``) in its own process, and a tracker killed
by SIGKILL takes the store with it while the world formed from it lives
on; a tracker resumed from its journal does not host the dead epoch's
store again. This probe forms a world of ``--world`` processes (NCCL, one
card a process, the communicator formed eagerly through ``device_id`` as
the data plane forms it; gloo with ``--device cpu``) from a store hosted
by a process of its own, kills that process with SIGKILL once every rank
has run one allreduce, lets the world idle ``--idle`` seconds, and then
has every rank run, each step under a limit of ``--hold`` seconds: 20
allreduces of 2048 f32 on the world's communicator, a barrier, a send
and receive between ranks 0 and 1, a new group of ranks 0 and 1 with an
allreduce on it, and the world's destroy. A step that outlasts its limit
ends the rank's probe (it is reported as hung; later steps do not run).

It prints, and writes to ``--out``, one JSON document: by rank, each
step's outcome (``ok``, the exception's type and first line, or
``hung``) and seconds, and the lines the rank wrote to stderr after the
kill (torch's and NCCL's own reports).

    python -m rabit_tpu_torch.tools.store_loss --world 2 [--device cpu]
        [--idle 10] [--hold 20] [--out build/artifacts/store_loss.json]

Without ``--device cpu`` it needs ``--world`` cards and raises without
them.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

STEPS = ("allreduce", "barrier", "send_recv", "new_group", "destroy")
ALLREDUCES = 20
ELEMS = 2048


def _host_store() -> None:
    """The store's own process: hosts a TCPStore, prints its port, waits
    to be killed."""
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=300))
    print(store.port, flush=True)
    time.sleep(3600)


def _step(fn, hold: float) -> dict:
    """Run ``fn`` on a thread of its own; its outcome within ``hold`` s."""
    res: dict = {}

    def run():
        t0 = time.perf_counter()
        try:
            fn()
            res["outcome"] = "ok"
        except Exception as e:  # noqa: BLE001 - the outcome is the finding
            first = (str(e).strip().splitlines() or [""])[0]
            res["outcome"] = f"{type(e).__name__}: {first[:300]}"
        res["s"] = time.perf_counter() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(hold)
    if th.is_alive():
        return {"outcome": "hung", "s": hold}
    return res


def _rank(rank: int, world: int, store_addr: str, device: str, ctl: Path,
          idle: float, hold: float) -> None:
    """One rank of the probe; writes ``ctl/r<rank>.json`` and exits."""
    import torch
    import torch.distributed as dist
    host, _, port = store_addr.rpartition(":")
    store = dist.TCPStore(host, int(port), is_master=False,
                          timeout=datetime.timedelta(seconds=30))
    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world, device_id=dev,
                                timeout=datetime.timedelta(seconds=hold))
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=hold))
    x = torch.full((ELEMS,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    if device == "cuda":
        torch.cuda.synchronize()
    want = world * (world + 1) / 2
    if float(x[0]) != want:
        raise AssertionError(f"rank {rank}: {float(x[0])} != {want}")
    (ctl / f"ready{rank}").write_text("1")
    while not (ctl / "killed").exists():
        time.sleep(0.05)
    time.sleep(idle)

    def allreduces():
        for _ in range(ALLREDUCES):
            y = torch.full((ELEMS,), float(rank + 1), device=dev)
            dist.all_reduce(y)
        if device == "cuda":
            torch.cuda.synchronize()
        if float(y[0]) != want:
            raise AssertionError(f"allreduce gave {float(y[0])}")

    def barrier():
        if device == "cuda":
            dist.barrier(device_ids=[rank])
            torch.cuda.synchronize()
        else:
            dist.barrier()

    def send_recv():
        if rank > 1:
            return
        z = torch.full((ELEMS,), float(rank), device=dev)
        if rank == 0:
            dist.send(z, 1)
        else:
            dist.recv(z, 0)
            if float(z[0]) != 0.0:
                raise AssertionError(f"received {float(z[0])}")
        if device == "cuda":
            torch.cuda.synchronize()

    def new_group():
        g = dist.new_group([0, 1])
        if rank <= 1:
            w = torch.ones(ELEMS, device=dev)
            dist.all_reduce(w, group=g)
            if device == "cuda":
                torch.cuda.synchronize()

    steps = {"allreduce": allreduces, "barrier": barrier,
             "send_recv": send_recv, "new_group": new_group,
             "destroy": dist.destroy_process_group}
    doc = {"rank": rank, "steps": {}}
    for name in STEPS:
        got = _step(steps[name], hold)
        doc["steps"][name] = got
        if got["outcome"] == "hung":
            break
    (ctl / f"r{rank}.json").write_text(json.dumps(doc))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def probe(world: int, device: str = "cuda", idle: float = 10.0,
          hold: float = 20.0, out: Optional[str] = None) -> dict:
    """Run the probe (see the module's docstring); returns its document."""
    import tempfile
    if device == "cuda":
        import torch
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"store_loss: a world of {world} needs "
                               f"{world} cards, found "
                               f"{torch.cuda.device_count()}")
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root,
                                                      env.get("PYTHONPATH")]))
    me = [sys.executable, "-m", "rabit_tpu_torch.tools.store_loss"]
    host = subprocess.Popen(me + ["--host-store"], env=env,
                            stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    ranks = []
    with tempfile.TemporaryDirectory() as tmp:
        ctl = Path(tmp)
        try:
            port = int(host.stdout.readline())
            for r in range(world):
                err = open(ctl / f"err{r}.txt", "w")
                ranks.append(subprocess.Popen(
                    me + ["--rank", str(r), "--world", str(world),
                          "--store", f"127.0.0.1:{port}", "--device",
                          device, "--ctl", str(ctl), "--idle", str(idle),
                          "--hold", str(hold)],
                    env=env, stderr=err, start_new_session=True))
            deadline = time.monotonic() + 300
            while not all((ctl / f"ready{r}").exists()
                          for r in range(world)):
                if time.monotonic() > deadline or \
                        any(p.poll() not in (None, 0) for p in ranks):
                    raise RuntimeError("store_loss: the world never formed")
                time.sleep(0.05)
            marks = {r: (ctl / f"err{r}.txt").stat().st_size
                     for r in range(world)}
            os.kill(host.pid, signal.SIGKILL)
            host.wait()
            (ctl / "killed").write_text("1")
            limit = time.monotonic() + idle + hold * len(STEPS) + 60
            for p in ranks:
                p.wait(max(1.0, limit - time.monotonic()))
            doc = {"world": world, "device": device, "idle_s": idle,
                   "hold_s": hold, "ranks": {}}
            for r in range(world):
                path = ctl / f"r{r}.json"
                got = (json.loads(path.read_text()) if path.exists()
                       else {"rank": r, "steps": None})
                text = (ctl / f"err{r}.txt").read_text()
                # torch's reports, without their C++ stack frames
                got["stderr_after_kill"] = [
                    ln for ln in text[marks[r]:].splitlines()
                    if ln.strip() and not ln.startswith(
                        ("frame #", "<omitting python frames>"))][:40]
                got["rc"] = ranks[r].returncode
                doc["ranks"][r] = got
        finally:
            for p in ranks + [host]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if device == "cuda":
        import torch
        doc["card"] = torch.cuda.get_device_name(0)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(doc, indent=1))
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--idle", type=float, default=10.0)
    ap.add_argument("--hold", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--host-store", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ctl", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.host_store:
        _host_store()
        return 0
    if args.rank is not None:
        _rank(args.rank, args.world, args.store, args.device,
              Path(args.ctl), args.idle, args.hold)
        return 0
    doc = probe(args.world, args.device, args.idle, args.hold, args.out)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
