"""Groups of gloo CPU ranks for the tests, started one way by every test
file that starts ranks: ``torchrun`` (``torch.distributed.run
--standalone``: its rendezvous store binds a port the system picks, so no
group can be handed another's) with an environment cleared of rank and
rendezvous variables, each rank running its target through this file.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/ranks.py <script.py | -m module> [args...]

A rank runs the target as ``__main__`` and then closes the world
(``launch.mesh.close_world``): the default group destroyed, then the
garbage that still refers to the rank's groups collected, so that gloo's
threads (``gloo_tcp_loop``, ``pt_gloo_runloop``) are joined before the
interpreter shuts down. Without it a group outlives
``destroy_process_group`` while a ``DeviceMesh`` or a DTensor refers to
it, its threads run on into interpreter shutdown, and now and then one
aborts the rank after its work is done (``terminate called without an
active exception``, SIGABRT, the main thread in no Python frame): with
8-14 groups of 4 ranks starting at once on 8 cores, 12 groups of 268
without ``close_world``, none of 140 with it.

``free_port`` gives a ``COORDINATOR_ADDRESS`` start (whose port the ranks
must be told) a port below the system's ephemeral range, which the system
never hands to a socket bound to port 0 or to an outgoing connection, so
no other group's rendezvous or gloo pair can take it before rank 0 binds
it.
"""
import os
import pathlib
import random
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "GROUP_RANK", "ROLE_RANK", "ROLE_WORLD_SIZE", "MASTER_ADDR",
             "MASTER_PORT", "COORDINATOR_ADDRESS")


def env(**extra) -> dict:
    """This process's environment without rank or rendezvous variables,
    one OpenMP thread a rank, ``src`` and ``tests`` on the path, and
    ``extra``."""
    out = {k: v for k, v in os.environ.items()
           if k not in RANK_VARS and not k.startswith("TORCHELASTIC_")}
    out.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)), **extra)
    return out


def torchrun(n: int, *target) -> list:
    """The command that runs ``target`` (a script path and its arguments,
    or ``"-m", module, ...``) on ``n`` ranks."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={n}", __file__, *map(str, target)]


def start(args, env_=None) -> subprocess.Popen:
    return subprocess.Popen(args, env=env_ or env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(procs: dict, timeout: int = TIMEOUT_S) -> dict:
    """Each process's output once it has ended with 0; on a time limit
    every process is killed."""
    outs = {}
    for name, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
        assert proc.returncode == 0, f"{name}:\n{out[-6000:]}"
        outs[name] = out
    return outs


def run(n: int, *target, timeout: int = TIMEOUT_S) -> str:
    """``target`` on ``n`` ranks, to its end; its output."""
    return finish({"ranks": start(torchrun(n, *target))}, timeout)["ranks"]


def _ephemeral_low() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port() -> int:
    """A port on 127.0.0.1 that nothing holds, below the ephemeral
    range."""
    hi = _ephemeral_low()
    for _ in range(200):
        port = random.randrange(max(1024, hi - 12000), hi)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port below the ephemeral range")


def rank_main(argv: list) -> int:
    """One rank: ``argv``'s target as ``__main__``, then the world
    closed."""
    import runpy

    from repro_torch.launch.mesh import close_world

    code = 0
    try:
        if argv[0] == "-m":
            sys.argv = argv[1:]
            runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
        else:
            sys.argv = list(argv)
            runpy.run_path(argv[0], run_name="__main__")
    except SystemExit as e:
        code = e.code
    close_world()
    return code


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
