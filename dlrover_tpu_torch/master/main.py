"""The master process: ``python -m dlrover_tpu_torch.master.main`` — the
port's own copy of ``dlrover_tpu/master/main.py`` (``parse_args``,
``run``, ``main``) for the local platform.

``--port`` (0: a free one), ``--port_file`` (the bound port is written
there, for the launcher), ``--job_name``, ``--min_nodes``,
``--max_nodes``, ``--node_unit`` and ``--network_check`` work.  The
reference's other flags are taken and refused by name:
``--state_dir``, ``--standby`` and ``--primary_addr`` (``HA_ITEM``),
``--brain_addr``, ``--cell_id``, ``--cell_registry`` and a ``--platform``
other than ``local`` (``HOST_LAYERS``).
"""

from __future__ import annotations

import argparse
import os
import sys

from dlrover_tpu_torch.common.constants import HA_ITEM, HOST_LAYERS
from dlrover_tpu_torch.common.log import logger, set_role


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dlrover_tpu_torch master")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--job_name", default="local-job")
    p.add_argument("--platform", default="local",
                   choices=["local", "process", "gke", "ray"])
    p.add_argument("--min_nodes", type=int, default=1)
    p.add_argument("--max_nodes", type=int, default=1)
    p.add_argument("--node_unit", type=int, default=1)
    p.add_argument("--network_check", action="store_true")
    p.add_argument("--port_file", default="",
                   help="write the bound port to this file")
    p.add_argument("--brain_addr", default="")
    p.add_argument("--state_dir", default="")
    p.add_argument("--standby", action="store_true")
    p.add_argument("--primary_addr", default="")
    p.add_argument("--cell_id", default="")
    p.add_argument("--cell_registry", default="")
    return p.parse_args(argv)


def refuse_later_options(args: argparse.Namespace) -> None:
    refused = [
        (args.state_dir, "--state_dir", HA_ITEM),
        (args.standby, "--standby", HA_ITEM),
        (args.primary_addr, "--primary_addr", HA_ITEM),
        (args.brain_addr, "--brain_addr (the Brain service)", HOST_LAYERS),
        (args.cell_id, "--cell_id (the multi-cell control plane)",
         HOST_LAYERS),
        (args.cell_registry, "--cell_registry", HOST_LAYERS),
        (args.platform != "local",
         f"--platform {args.platform} (a distributed job master)",
         HOST_LAYERS),
    ]
    for on, what, where in refused:
        if on:
            raise NotImplementedError(f"{what} comes with {where}")


def run(args: argparse.Namespace) -> int:
    refuse_later_options(args)
    set_role("master")
    from dlrover_tpu_torch.master.master import LocalJobMaster

    master = LocalJobMaster(args.port, job_name=args.job_name,
                            min_nodes=args.min_nodes,
                            max_nodes=args.max_nodes,
                            node_unit=args.node_unit,
                            network_check=args.network_check)
    master.prepare()
    if args.port_file:
        tmp = f"{args.port_file}.tmp"
        with open(tmp, "w") as f:
            f.write(str(master.port))
        os.replace(tmp, args.port_file)  # never read half-written
    logger.info("master listening on port %d", master.port)
    return master.run()


def main() -> None:
    sys.exit(run(parse_args()))


if __name__ == "__main__":
    main()
