"""Multi-host set-up of the port (``any4_tpu_torch/parallel/distributed.py``),
on the pattern of ``tests/test_distributed.py``.

Four real processes stand for 2 hosts x 2 local ranks: each gets the
environment ``torchrun`` would give it (``MASTER_ADDR``/``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``GROUP_RANK``), joins the gloo world through ``initialize()`` with no
arguments, builds the multi-host mesh, and runs an all-reduce over its tp
group (inside a host) and over its dp group (across hosts), so that the
code path is executed, not only imported. Each process has a 180 s
timeout and runs torch on one thread.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as dist

from any4_tpu_torch.parallel import distributed

_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist

    from any4_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    rank = int(sys.argv[1])
    assert distributed.initialize() is True
    assert dist.get_world_size() == 4 and dist.get_rank() == rank
    assert distributed.is_primary() == (rank == 0)
    mesh = distributed.make_multihost_mesh(tp=2, device="cpu")
    assert mesh.shape == {{"dp": 2, "tp": 2}}
    assert (mesh.dp_rank, mesh.tp_rank) == (rank // 2, rank % 2)
    # tp inside a host: the tp group is this host's two ranks
    x = torch.tensor([float(rank)])
    dist.all_reduce(x, group=mesh.tp_group)
    assert x.item() == {{0: 1.0, 1: 5.0}}[rank // 2], x
    # dp across hosts: ranks r and r + 2
    y = torch.tensor([float(rank)])
    dist.all_reduce(y, group=mesh.dp_group)
    assert y.item() == {{0: 2.0, 1: 4.0}}[rank % 2], y
    # the default tp is a host's rank count; tp=4 would span both hosts
    assert distributed.make_multihost_mesh(device="cpu").tp == 2
    try:
        distributed.make_multihost_mesh(tp=4, device="cpu")
    except ValueError as e:
        assert "host" in str(e), e
    else:
        raise AssertionError("tp=4 across two hosts was accepted")
    dist.destroy_process_group()
    print(f"worker {{rank}} OK", flush=True)
""")


def test_four_process_two_host_mesh(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo))
    base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []
    for r in range(4):
        env = dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(r), WORLD_SIZE="4", LOCAL_RANK=str(r % 2),
                   LOCAL_WORLD_SIZE="2", GROUP_RANK=str(r // 2),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(r)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"worker {i} OK" in out


def test_initialize_without_address_or_env(monkeypatch):
    """A lone process (no address, no torchrun environment) joins nothing,
    as the JAX package's ``initialize`` returns False there; half an
    address is refused."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not dist.is_initialized()
    assert distributed.is_primary()
    with pytest.raises(ValueError, match="together"):
        distributed.initialize(address="tcp://127.0.0.1:1")
