"""Node agent process entrypoint.

The port's copy of batch_shipyard_tpu/agent/__main__.py, started by the
localhost substrate (subprocess per node). All wiring comes from a JSON
bootstrap file (the reference's schema) to keep the exec contract
trivial:

    python -m batch_shipyard_tpu_torch.agent /path/to/bootstrap.json

Bootstrap schema: {
  storage: {backend, root|bucket, prefix},
  pool_config: <raw pool yaml dict>,
  identity: {pool_id, node_id, node_index, hostname, internal_ip,
             slice_index, worker_index},
  work_dir: str, heartbeat_interval: float, poll_interval: float
}
"""

from __future__ import annotations

import json
import logging
import signal
import sys

from batch_shipyard_tpu_torch.agent.cascade import CascadeImageProvisioner
from batch_shipyard_tpu_torch.agent.node_agent import NodeAgent, NodeIdentity
from batch_shipyard_tpu_torch.agent.nodeprep import run_node_prep
from batch_shipyard_tpu_torch.config import settings as settings_mod
from batch_shipyard_tpu_torch.config.settings import StorageCredentialsSettings
from batch_shipyard_tpu_torch.state.factory import create_statestore


def main(argv: list[str]) -> int:
    with open(argv[1], "r", encoding="utf-8") as fh:
        boot = json.load(fh)
    storage = StorageCredentialsSettings(
        backend=boot["storage"]["backend"],
        bucket=boot["storage"].get("bucket"),
        prefix=boot["storage"].get("prefix", "shipyardtpu"),
        root=boot["storage"].get("root"),
    )
    if "resilience" in boot:
        # The reference's store-outage ride-through (its
        # state/resilient.py) is not ported yet: the agent talks to the
        # store directly.
        logging.getLogger(__name__).warning(
            "bootstrap 'resilience' block ignored: the store-outage "
            "ride-through is not ported yet")
    store = create_statestore(storage)
    pool = settings_mod.pool_settings(boot["pool_config"])
    identity = NodeIdentity(**boot["identity"])
    provisioner = CascadeImageProvisioner(store)
    agent = NodeAgent(
        store, identity, pool, work_dir=boot["work_dir"],
        heartbeat_interval=boot.get("heartbeat_interval", 10.0),
        poll_interval=boot.get("poll_interval", 0.5),
        node_stale_seconds=boot.get("node_stale_seconds", 30.0),
        nodeprep=(run_node_prep if boot.get("run_nodeprep", True)
                  else None),
        image_provisioner=provisioner,
        output_upload_cap_bytes=boot.get("output_upload_cap_bytes"))

    def _stop(signum, frame):
        agent.stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    agent.start()
    agent.join()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
