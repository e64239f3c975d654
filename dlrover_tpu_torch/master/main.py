"""The master process: ``python -m dlrover_tpu_torch.master.main`` — the
port's own copy of ``dlrover_tpu/master/main.py`` (``parse_args``,
``run_standby``, ``run``, ``main``) for the local platform.

``--port`` (0: a free one), ``--port_file`` (the bound port is written
there, for the launcher), ``--job_name``, ``--min_nodes``,
``--max_nodes``, ``--node_unit`` and ``--network_check`` work, and so does
master HA: ``--state_dir D`` journals the control state in ``D`` (and
recovers what an earlier master journaled there), and ``--standby
--state_dir D [--primary_addr A]`` runs a warm standby that binds its port
up front, tails ``D`` and takes over when the primary goes silent
(``master/standby.py``).  The reference's other flags are taken and refused
by name: ``--brain_addr``, ``--cell_id``, ``--cell_registry`` and a
``--platform`` other than ``local`` (``HOST_LAYERS``); its chaos sites
(``master.kill``, ``master.restart``) come with ``CHAOS_LAYER``.
"""

from __future__ import annotations

import argparse
import os
import sys

from dlrover_tpu_torch.common.constants import HOST_LAYERS
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
    p.add_argument("--state_dir", default="",
                   help="durable control state: journal the mutations "
                        "here, recover on a relaunch, let a standby adopt")
    p.add_argument("--standby", action="store_true",
                   help="run as a warm standby: tail --state_dir, bind the "
                        "port now, take over when the primary goes silent")
    p.add_argument("--primary_addr", default="",
                   help="standby: the primary's host:port (default: the "
                        "state dir's addr file), probed before a takeover")
    p.add_argument("--cell_id", default="")
    p.add_argument("--cell_registry", default="")
    return p.parse_args(argv)


def refuse_later_options(args: argparse.Namespace) -> None:
    refused = [
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


def _write_port(port_file: str, port: int) -> None:
    tmp = f"{port_file}.tmp"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, port_file)  # never read half-written


def run_standby(args: argparse.Namespace) -> int:
    """Bind, tail, take over, serve."""
    set_role("master-standby")
    if not args.state_dir:
        logger.error("--standby requires --state_dir")
        return 2
    from dlrover_tpu_torch.master.standby import StandbyMaster

    sb = StandbyMaster(args.state_dir, port=args.port,
                       primary_addr=args.primary_addr,
                       job_name=args.job_name, min_nodes=args.min_nodes,
                       max_nodes=args.max_nodes, node_unit=args.node_unit,
                       network_check=args.network_check)
    if args.port_file:
        _write_port(args.port_file, sb.port)
    logger.info("standby master bound on port %d", sb.port)
    return sb.run()


def run(args: argparse.Namespace) -> int:
    refuse_later_options(args)
    if args.standby:
        return run_standby(args)
    set_role("master")
    from dlrover_tpu_torch.master.master import LocalJobMaster

    master = LocalJobMaster(args.port, job_name=args.job_name,
                            min_nodes=args.min_nodes,
                            max_nodes=args.max_nodes,
                            node_unit=args.node_unit,
                            network_check=args.network_check,
                            state_dir=args.state_dir)
    master.prepare()
    if args.port_file:
        _write_port(args.port_file, master.port)
    logger.info("master listening on port %d", master.port)
    return master.run()


def main() -> None:
    sys.exit(run(parse_args()))


if __name__ == "__main__":
    main()
