"""Node agent process entrypoint.

The port's copy of batch_shipyard_tpu/agent/__main__.py, started by the
localhost substrate (subprocess per node) and by a cloud VM's startup
script (substrate/gcp_gpu.py). All wiring comes from a JSON bootstrap
file (the reference's schema) to keep the exec contract trivial:

    python -m batch_shipyard_tpu_torch.agent /path/to/bootstrap.json

Bootstrap schema: {
  storage: {backend, root|bucket, prefix},
  pool_config: <raw pool yaml dict>,
  identity: {pool_id, node_id, node_index, hostname, internal_ip,
             slice_index, worker_index},
  work_dir: str, heartbeat_interval: float, poll_interval: float,
  resilience: {ResilientStore knobs} | null
}

The agent rides store outages (state/resilient.py) unless the bootstrap
says ``"resilience": null``: a bootstrap without the key gets the
wrapper with its default knobs.
"""

from __future__ import annotations

import json
import signal
import sys
from typing import Optional

from batch_shipyard_tpu_torch.agent.cascade import CascadeImageProvisioner
from batch_shipyard_tpu_torch.agent.node_agent import NodeAgent, NodeIdentity
from batch_shipyard_tpu_torch.agent.nodeprep import run_node_prep
from batch_shipyard_tpu_torch.config import settings as settings_mod
from batch_shipyard_tpu_torch.config.settings import StorageCredentialsSettings
from batch_shipyard_tpu_torch.state.factory import create_statestore
from batch_shipyard_tpu_torch.utils import util

# Named for the package: run with -m, this module's __name__ is
# "__main__", outside the package logger's tree.
logger = util.get_logger("batch_shipyard_tpu_torch.agent")


def build_agent(boot: dict, store=None) -> NodeAgent:
    """The node agent a bootstrap describes, over ``store`` if given
    (else the one its storage block names)."""
    if store is None:
        storage = StorageCredentialsSettings(
            backend=boot["storage"]["backend"],
            bucket=boot["storage"].get("bucket"),
            prefix=boot["storage"].get("prefix", "shipyardtpu"),
            root=boot["storage"].get("root"),
        )
        store = create_statestore(storage)
    pool = settings_mod.pool_settings(boot["pool_config"])
    identity = NodeIdentity(**boot["identity"])
    provisioner = CascadeImageProvisioner(store)
    resilience: Optional[dict] = boot.get("resilience", {})
    return NodeAgent(
        store, identity, pool, work_dir=boot["work_dir"],
        heartbeat_interval=boot.get("heartbeat_interval", 10.0),
        poll_interval=boot.get("poll_interval", 0.5),
        node_stale_seconds=boot.get("node_stale_seconds", 30.0),
        nodeprep=(run_node_prep if boot.get("run_nodeprep", True)
                  else None),
        image_provisioner=provisioner,
        output_upload_cap_bytes=boot.get("output_upload_cap_bytes"),
        # Store-outage ride-through ON by default for real agent
        # processes: critical ops retry through outages, advisory
        # goodput/trace/heartbeat publishes journal to the node-local
        # WAL and replay in order on recovery (state/resilient.py).
        # Opt out (or tune) via the bootstrap's "resilience" block.
        resilience=resilience)


def main(argv: list[str]) -> int:
    with open(argv[1], "r", encoding="utf-8") as fh:
        boot = json.load(fh)
    agent = build_agent(boot)

    def _stop(signum, frame):
        agent.stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    agent.start()
    agent.join()
    backlog = getattr(agent.store, "journal_backlog", None)
    if callable(backlog):
        logger.info("store-outage ride-through: journal backlog %d at "
                    "exit", backlog())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
