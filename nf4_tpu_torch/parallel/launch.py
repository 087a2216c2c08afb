"""Start one process per rank on this host and run functions on all of them.

JAX drives every device from one program and needs no launcher; a
``torch.distributed`` job is one process per rank.  :class:`Ranks` starts
``world`` processes (``python -m nf4_tpu_torch.parallel.launch``, so a
rank imports the package and the module of the function it runs, never
the caller's script), joins them into one job (``initialize_distributed``
over a TCP store on ``localhost``) and then runs, on every rank,
``fn(mesh, *args, **kwargs)`` for each :meth:`Ranks.run`, ``mesh`` that
rank's :class:`~nf4_tpu_torch.parallel.mesh.Mesh` of the asked ``tp`` and
``dp`` (None on a rank outside it).  ``fn`` must be importable by name (a
module-level function) and its arguments and result picklable.  The
result of rank 0 comes back; an error on any rank stops every rank and is
raised in the caller with each failed rank's traceback.  Build the kernels
in the caller first (``ops._cuda.build()``): ranks load the built
libraries, where each rank would otherwise build what it lacks, the same
work once per rank.

    with Ranks(2, backend="gloo", device="cpu") as ranks:
        out = ranks.run(my_module.serve, prompts, tp=2)

With ``lead=True`` the caller is rank 0 of the job (the serving CLI over
ranks, whose HTTP front lives in rank 0): ``world - 1`` processes start
and the caller joins the job itself; :meth:`Ranks.start`,
:meth:`Ranks.mesh` and :meth:`Ranks.join` let it run a body of its own
beside the others'.  A rank process
exits when its caller's process ends (it watches its parent) and ignores
``SIGINT``: its caller stops it.
"""

from __future__ import annotations

import argparse
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from multiprocessing.connection import Connection, wait
from typing import Optional

__all__ = ["Ranks", "RankError"]

# The most seconds one Ranks.run may take.
RUN_TIMEOUT_S = 1800.0


class RankError(RuntimeError):
    """A function failed on one or more ranks; the message holds each
    failed rank's traceback."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` rank processes of one job on this host, kept until
    :meth:`close` (a context manager): ``backend`` and ``device`` as
    :func:`~nf4_tpu_torch.parallel.mesh.make_mesh` takes them, ``threads``
    the intra-op threads of each rank (default torch's), ``timeout`` the
    most seconds one :meth:`run` may take (default RUN_TIMEOUT_S; a run
    past it, such as ranks stuck in collectives that do not meet, raises
    and kills the ranks).  Each rank talks to the caller over a socket pair
    of its own, so a rank that dies shows as a closed connection.  With
    ``lead`` the caller is rank 0 (module docstring): the others start,
    and the caller joins the job here, with ``threads`` set for it too."""

    def __init__(self, world: int, backend: str = "nccl", device: Optional[str] = None,
                 threads: Optional[int] = None, timeout: float = RUN_TIMEOUT_S, lead: bool = False):
        import torch

        from .mesh import _check_backend, initialize_distributed

        self.world, self.timeout, self.lead = world, timeout, lead
        self.backend, self.device = backend, device or "cuda"
        _check_backend(backend, world, None if self.device == "cuda" else torch.device(self.device))
        store = f"localhost:{_free_port()}"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p or os.getcwd() for p in sys.path))
        cmd = [sys.executable, "-m", "nf4_tpu_torch.parallel.launch", "--world", str(world),
               "--store", store, "--backend", backend, "--device", self.device, "--threads", str(threads or 0)]
        self._procs, self._conns, self._meshes = [], [], {}
        self._first = 1 if lead else 0
        for r in range(self._first, world):
            ours, theirs = socket.socketpair()
            self._procs.append(subprocess.Popen(cmd + ["--rank", str(r), "--fd", str(theirs.fileno())], env=env,
                                                pass_fds=(theirs.fileno(),)))
            theirs.close()
            self._conns.append(Connection(ours.detach()))
        if lead:
            if threads:
                torch.set_num_threads(threads)
            try:
                initialize_distributed(store, world, 0, backend=backend)
            except BaseException:
                self.close(kill=True)
                raise

    def mesh(self, tp: Optional[int] = None, dp: int = 1):
        """The caller's :class:`~nf4_tpu_torch.parallel.mesh.Mesh` of ``tp``
        x ``dp`` (``lead`` only), made once, in step with the ranks, which
        make theirs when a job first asks for it."""
        from .mesh import make_mesh

        tp = tp or self.world // dp
        if (tp, dp) not in self._meshes:
            self._meshes[tp, dp] = make_mesh(tp, dp, backend=self.backend, device=self.device)
        return self._meshes[tp, dp]

    def run(self, fn, *args, tp: Optional[int] = None, dp: int = 1, **kwargs):
        """``fn(mesh, *args, **kwargs)`` on every rank, ``mesh`` of ``tp`` x
        ``dp`` (tp defaults to ``world / dp``); rank 0's result."""
        if self.lead:
            raise RuntimeError("the caller is rank 0 (lead=True): use start, mesh and join")
        self.start(fn, *args, tp=tp, dp=dp, **kwargs)
        return self.join()[0]

    def start(self, fn, *args, tp: Optional[int] = None, dp: int = 1, **kwargs) -> None:
        """Send ``fn(mesh, *args, **kwargs)`` to every rank process and
        return at once; :meth:`join` waits for their results."""
        if self._conns is None:
            raise RuntimeError("the ranks are closed")
        msg = pickle.dumps((fn, tp or self.world // dp, dp, args, kwargs))
        for conn in self._conns:
            conn.send_bytes(msg)

    def poll(self, timeout: float = 0.0) -> bool:
        """Has a rank process answered (a result, an error or its exit)
        within ``timeout`` seconds?  Nothing is read."""
        return bool(self._conns and wait(self._conns, timeout=timeout))

    def join(self) -> dict:
        """The results of the job :meth:`start` sent, by rank; any rank's
        error (or the timeout) stops every rank and raises
        :class:`RankError`."""
        results, errors = {}, {}
        pending = {conn: r for r, conn in enumerate(self._conns, start=self._first)}
        end = time.monotonic() + self.timeout
        while pending:
            # After a failure the others get a short while to report theirs.
            limit = end if not errors else min(end, time.monotonic() + 10.0)
            ready = wait(list(pending), timeout=max(0.0, limit - time.monotonic()))
            if not ready:
                for r in pending.values():
                    errors[r] = "stopped after another rank failed" if errors else "no answer in time"
                break
            for conn in ready:
                r = pending.pop(conn)
                try:
                    status, value = conn.recv()
                except (EOFError, OSError):
                    status, value = "error", f"the rank exited (code {self._procs[r - self._first].wait()})"
                (results if status == "ok" else errors)[r] = value
        if errors:
            self.close(kill=True)
            raise RankError("\n".join(f"rank {r}: {e}" for r, e in sorted(errors.items())))
        return results

    def close(self, kill: bool = False) -> None:
        """Stop every rank: a clean exit (with ``lead``, the caller then
        leaves the job), or at once with ``kill``."""
        if self._conns is None:
            return
        for conn in self._conns:
            try:
                if not kill:
                    conn.send_bytes(pickle.dumps(None))
                conn.close()
            except OSError:
                pass
        self._conns = None
        for p in self._procs:
            if kill:
                p.kill()
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if self.lead and not kill:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def _exit_with(parent: int) -> None:
    """End this process once its parent ``parent`` has ended (the rank is
    then an orphan, and nothing would ever stop it)."""
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(1)


def _serve(argv=None) -> int:
    """A rank's process: join the job, then run what the caller sends."""
    ap = argparse.ArgumentParser()
    for name in ("store", "backend", "device"):
        ap.add_argument(f"--{name}", required=True)
    for name in ("world", "rank", "threads", "fd"):
        ap.add_argument(f"--{name}", type=int, required=True)
    args = ap.parse_args(argv)
    conn = Connection(args.fd)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    threading.Thread(target=_exit_with, args=(os.getppid(),), name="nf4-parent-watch", daemon=True).start()

    import torch
    import torch.distributed as dist

    from .mesh import initialize_distributed, make_mesh

    if args.threads:
        torch.set_num_threads(args.threads)
    initialize_distributed(args.store, args.world, args.rank, backend=args.backend)
    meshes = {}
    while True:
        try:
            msg = conn.recv_bytes()
        except (EOFError, OSError):
            break
        try:
            job = pickle.loads(msg)
            if job is None:
                break
            fn, tp, dp, a, kw = job
            if (tp, dp) not in meshes:  # every rank makes every mesh: new_group is collective
                meshes[tp, dp] = make_mesh(tp, dp, backend=args.backend, device=args.device)
            mesh = meshes[tp, dp]
            reply = ("ok", None if mesh is None else fn(mesh, *a, **kw))
        except BaseException:
            reply = ("error", traceback.format_exc())
        conn.send(reply)
        if reply[0] == "error":
            break
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_serve())
