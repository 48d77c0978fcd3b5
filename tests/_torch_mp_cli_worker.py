"""One rank of the port's CLI under torchrun's environment, on the CPU
(tests/test_torch_port_bringup.py): the counterpart of
tests/_mp_cli_worker.py.

It sets only what torchrun would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and ``GM2_ROOT``, then runs
``genome_minimizer_2_torch.cli.main`` once per argument list: the first
call forms the gloo group inside ``main`` (``maybe_initialize``), and
``main`` closes it again at its end, so each list runs on a fresh port
given after it, as ``<port>:<arg> <arg> ...``.

Usage: _torch_mp_cli_worker.py <rank> <world> <root> <port>:<argv> ...
"""

import os
import shlex
import sys

rank, world, root = sys.argv[1], sys.argv[2], sys.argv[3]
os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                  MASTER_ADDR="localhost", GM2_ROOT=root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from genome_minimizer_2_torch import cli  # noqa: E402

for call in sys.argv[4:]:
    port, argv = call.split(":", 1)
    os.environ["MASTER_PORT"] = port
    rc = cli.main(shlex.split(argv))
    assert not dist.is_initialized(), "main() left its group open"
    print(f"CLI_OK rank={rank} rc={rc}", flush=True)
    if rc:
        sys.exit(rc)
