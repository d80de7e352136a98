"""The per-test wall-clock limit of the repository's ``conftest.py``, on a hung test.

A pytest run of its own, in a subprocess, under xdist: its conftest arms
this repo's hookwrappers with a 2 s limit, one test hangs the way an
asyncio server does when a handler never closes its writer (Python 3.12's
``Server.wait_closed`` waits for every connection), and one test passes.
The hang must end as a named failure and the run must reach its end.
"""

import os
import subprocess
import sys
import textwrap

REPO_CONFTEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conftest.py")

CONFTEST = f"""
import importlib.util

spec = importlib.util.spec_from_file_location("repo_conftest", {REPO_CONFTEST!r})
repo = importlib.util.module_from_spec(spec)
spec.loader.exec_module(repo)

pytest_runtest_setup = repo.limit_phase("setup", 2)
pytest_runtest_call = repo.limit_phase("call", 2)
pytest_runtest_teardown = repo.limit_phase("teardown", 2)
"""

HANG = """
import asyncio


def test_hang():
    async def go():
        async def handler(reader, writer):
            await reader.readline()  # returns, never closing its writer

        server = await asyncio.start_server(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        _, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.close()
        await writer.wait_closed()
        server.close()
        await server.wait_closed()  # waits for the server's open end

    asyncio.run(go())
"""

PASS = """
def test_passes():
    assert sum(range(4)) == 6
"""


def test_hung_test_fails_by_name_and_the_run_ends(tmp_path):
    for name, body in (("conftest.py", CONFTEST), ("test_hang.py", HANG),
                       ("test_pass.py", PASS)):
        (tmp_path / name).write_text(textwrap.dedent(body))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "xdist", "-n", "2", "--dist", "loadfile",
         str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=60,
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "test_hang.py::test_hang: call ran past 2 s" in out, out
    assert "PASSED test_pass.py::test_passes" in out, out
    assert "1 failed, 1 passed" in out, out
