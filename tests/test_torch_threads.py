"""The port under threads (a serve group's ranks are threads of one
process): the kernel library is built once whichever threads ask for it
first, and no launch or host-sync count is lost to concurrent increments —
a lost sync would let the "≤ 2 syncs per window" gate pass wrongly.
Each test runs 8 threads. And under processes (a multi-host fleet's
workers): two processes that build into an empty build directory at once
compile each source once, through a stand-in ``nvcc``."""
import os
import subprocess
import sys
import textwrap
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from repro_torch.core.device_channel import readback
from repro_torch.kernels import (WRAPPERS, build, launch_counts,
                                 reset_launch_counts)
from repro_torch.kernels.build import count_launch

THREADS, INCREMENTS = 8, 10_000


def _together(fn):
    """Run ``fn`` on THREADS threads released at once, switching threads as
    often as the interpreter allows; re-raise any error."""
    start = threading.Barrier(THREADS)
    errors = []

    def run():
        start.wait()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_library_builds_once_under_threads(monkeypatch, tmp_path):
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.05)            # wide enough for every thread to arrive
        return tmp_path / "lib.so"

    fake = SimpleNamespace(**{n: SimpleNamespace() for n in build.SIGNATURES})
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: fake)
    got = []
    _together(lambda: got.append(build.library()))
    assert len(calls) == 1
    assert len(got) == THREADS and all(lib is fake for lib in got)
    assert all(getattr(fake, n).restype is build.ctypes.c_int
               for n in build.SIGNATURES)


FAKE_NVCC = """\
#!{python}
import sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(("link" if "-shared" in args else args[args.index("-c") + 1]) + "\\n")
time.sleep(0.3)                      # wide enough for the other process
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
"""

BUILDER = textwrap.dedent("""
    import sys
    from pathlib import Path
    import repro_torch.kernels.build as b
    b.BUILD_DIR = Path(sys.argv[1])
    b._nvcc = lambda: sys.argv[2]
    print(b.build())
""")


def test_library_builds_once_across_processes(tmp_path):
    """Two processes call ``build()`` on an empty build directory at once:
    one compiles every source and links once under the lock; the other
    waits, finds the library and returns its path. Every object is in
    place under its final name, and no process-named file is left."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    out = tmp_path / "build"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(out), str(nvcc)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for _ in range(2)]
    results = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), results
    paths = {o.strip() for o, _ in results}
    assert len(paths) == 1
    so = paths.pop()
    assert so.endswith(".so") and open(so).read() == "built"
    compiled = log.read_text().split()
    sources = [str(s) for s in build.sources()]
    assert sorted(compiled) == sorted(sources + ["link"])
    for s in build.sources():
        assert (out / f"{s.stem}-{so.rsplit('-', 1)[1][:-3]}.o").read_text() == "built"
    assert not [f for f in os.listdir(out) if f.endswith((".tmp",))
                or f.count(".") > 1 and f.split(".")[-2].isdigit()]


@pytest.fixture
def zero_counts():
    reset_launch_counts()
    yield
    reset_launch_counts()


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=lambda w: w.__name__)
def test_launch_counts_lose_no_increment(zero_counts, wrapper):
    kernel = next(iter(getattr(wrapper, "kernel_launches", {})), None)

    def launch():
        for _ in range(INCREMENTS):
            count_launch(wrapper, kernel)

    _together(launch)
    counts = launch_counts()
    assert counts[wrapper.__name__] == THREADS * INCREMENTS
    if kernel is not None:
        assert counts[kernel] == THREADS * INCREMENTS


def test_readback_count_loses_no_increment():
    t = torch.zeros(1, dtype=torch.int32)
    readback.count = 0

    def read():
        for _ in range(INCREMENTS):
            readback(t)

    _together(read)
    assert readback.count == THREADS * INCREMENTS
