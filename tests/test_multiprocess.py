"""The REAL multi-process ``jax.distributed`` path, executed.

Everything else multi-device in this suite runs on a single-process virtual
mesh; this test spawns TWO separate Python processes (coordinator + worker,
Gloo CPU collectives over localhost) and drives the sharded PPO train step
over the global mesh end-to-end — the initialize -> multihost_env_mesh ->
shard_map -> pmean chain across a process boundary. Processes are spawned
on the CPU only: on a GPU machine each process would reserve most of the
card's memory, so the card runs one process.

The demo prints one RESULT line per process; the coordinator asserts the
parameter checksums agree and prints the OK line this test checks.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


import pytest


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_two_process_distributed_training(algo):
    # subprocess.run's own timeout=540 bounds the test; pytest-timeout is
    # not installed in this image. SAC additionally crosses the process
    # boundary with a PER-PROCESS replay-buffer shard (writes/samples stay
    # local, only gradients pmean across).
    port = 29600 + (os.getpid() + (0 if algo == "ppo" else 7)) % 200
    env = dict(os.environ)
    # the demo pins its own platform/device-count env; drop the suite's
    # 8-virtual-device XLA_FLAGS so each process gets its own 2
    env.pop("XLA_FLAGS", None)
    # the demo imports the package from the checkout, which is not installed
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "multihost_demo.py"),
         "--spawn", "2", "--local-devices", "2", "--iters", "2",
         "--algo", algo, "--coordinator", f"localhost:{port}"],
        capture_output=True, text=True, timeout=540, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    results = [l for l in out.splitlines() if l.startswith("RESULT ")]
    assert len(results) == 2, out
    assert any(l.startswith("OK: 2 processes agree") for l in out.splitlines()), out
    # both processes saw the full 4-device global mesh
    assert all("devices=4" in l for l in results), out
    assert all(f"algo={algo}" in l for l in results), out
