"""Multi-process end-to-end: a torch.distributed gloo group of 2
processes x 2 CPU doc shards, both sharded engines over a doc axis that
spans the processes, oracle-checked on process 0, and each engine's
device checkpoint saved (each process its own shards) and loaded back
bit-equal (``bm25_tpu_torch.parallel._multihost_main``, the port's
counterpart of ``tests/test_multihost.py``)."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_group_matches_oracle(tmp_path):
    port = _free_port()
    ck = str(tmp_path / "ck")
    nproc, shards_per_proc = 2, 2
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bm25_tpu_torch.parallel._multihost_main",
         str(pid), str(nproc), str(port), str(shards_per_proc),
         "--device", "cpu", "--checkpoint", ck],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[0].returncode == 0, f"p0 failed:\n{outs[0][-2000:]}"
    assert procs[1].returncode == 0, f"p1 failed:\n{outs[1][-2000:]}"
    assert "MULTIHOST_OK" in outs[0], outs[0][-2000:]
    assert "CHECKPOINT_OK" in outs[0], outs[0][-2000:]
    for name in ("ShardedSparseEngine", "ShardedEngine"):
        # process 0's shards and the sidecar, process 1's shards
        for suffix in ("", ".p1", ".meta.json"):
            assert os.path.isfile(f"{ck}.{name}{suffix}"), (name, suffix)
        assert "checkpoint round trip: bit-equal" in outs[1]
    assert f"{nproc * shards_per_proc} global shards (gloo" in outs[0]
    assert "MULTIHOST" not in outs[1]
