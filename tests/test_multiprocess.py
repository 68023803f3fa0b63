"""Multi-PROCESS distributed training (tests the jax.distributed path).

Everything else in tests/ exercises the SPMD programs on a virtual
multi-device mesh inside ONE process; this launches TWO OS processes
wired together with ``parallel.multihost.initialize`` (the exact API a
multi-host cluster uses, SURVEY.md section 2.6) and runs the full
distributed DQN training step over a global mesh spanning both -- the
cross-process gradient psum and the tensor-parallel psum("model") both
cross the process boundary (collectives ride Gloo on CPU, NCCL on GPUs;
same program).

Pass criterion: each process reports the same env-step count and the
SAME replicated-params checksum after 3 chunks -- params stayed
bitwise-replicated through cross-process collectives.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
@pytest.mark.parametrize("num_procs", [2, 4])
def test_multi_process_distributed_training(num_procs, tmp_path):
    """2 processes = the minimal cross-boundary topology; 4 processes =
    the BASELINE multi-host target shape (4 hosts), exercising a
    non-trivial >2-rank Gloo allreduce tree.  Covers the XLA dp x tp DQN
    step, the data-parallel Rainbow/HDQN/DRQN families and the
    multi-host checkpoint/resume roundtrip (CKPT tag: restore-then-
    continue bitwise equals the uninterrupted run)."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MGT_MP_CKPT_DIR"] = str(tmp_path / "mp_ckpt")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "examples",
                                          "multiprocess_dryrun.py"),
             str(i), str(num_procs), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(num_procs)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300 * num_procs)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    ndev = 2 * num_procs         # 2 virtual devices per process
    for tag, steps in (("OK", 9 * (ndev // 2) * 4),
                       ("RAINBOW OK", 6 * ndev * 4),
                       ("HDQN OK", 6 * ndev * 4),
                       ("DRQN OK", 6 * ndev * 4),
                       ("CKPT OK", 15 * (ndev // 2) * 4)):
        want = [ln for out in outs for ln in out.splitlines()
                if any(ln.startswith(f"PROC{i} {tag} env_steps")
                       for i in range(num_procs))]
        assert len(want) == num_procs, (tag, outs)
        # Same step count, same replicated-params checksum on EVERY
        # process (dp x tp DQN step, then the data-parallel families).
        body = {ln.split(" ", 1)[1].split(" ", 1)[1] for ln in want}
        assert len(body) == 1, want
        assert f"env_steps={steps}" in want[0]
