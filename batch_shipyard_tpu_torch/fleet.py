"""Fleet orchestration: one action_* function per CLI verb.

Reference analog: convoy/fleet.py (5486 LoC, ~90 action_* functions,
fleet.py:2974-5486). Ours is thinner because the heavy lifting lives in
the domain services (pool/jobs managers) and on the node agents; fleet
owns config loading/validation, wiring (state store + substrate), and
the cross-service flows.

The port's copy of batch_shipyard_tpu/fleet.py: the same actions over the
port's pool and jobs managers, store and substrates (fake, localhost), so
a configdir either package's CLI reads gives the same output from the
other's. Not here yet: the chaos, sim and lint actions (their modules are
not ported), and the quota preflight, which comes with the H100 VM
substrate.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from typing import Any, Optional

import yaml

from batch_shipyard_tpu_torch.config import settings as settings_mod
from batch_shipyard_tpu_torch.config.validator import ConfigType, validate_config
from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
from batch_shipyard_tpu_torch.pool import manager as pool_mgr
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import StateStore
from batch_shipyard_tpu_torch.state.factory import create_statestore
from batch_shipyard_tpu_torch.substrate.base import (
    ComputeSubstrate, create_substrate)
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

_CONFIG_TYPES = {
    "credentials": ConfigType.CREDENTIALS,
    "config": ConfigType.GLOBAL,
    "pool": ConfigType.POOL,
    "jobs": ConfigType.JOBS,
    "fs": ConfigType.REMOTEFS,
    "monitor": ConfigType.MONITOR,
    "federation": ConfigType.FEDERATION,
    "slurm": ConfigType.SLURM,
}


@dataclasses.dataclass
class Context:
    """CliContext analog (shipyard.py:55): loaded+validated configs and
    lazily constructed clients."""

    configs: dict[str, dict]
    _store: Optional[StateStore] = None
    _substrates: dict[str, ComputeSubstrate] = dataclasses.field(
        default_factory=dict)
    substrate_kwargs: dict[str, Any] = dataclasses.field(
        default_factory=dict)
    _resolved_credentials: Optional[dict] = None

    # ------------------------- config access ---------------------------

    @property
    def secret_io(self) -> tuple:
        """(secrets_file, gcp_project) for secret:// resolution and
        storage — the single place that knows where these live in the
        credentials config (used by lazy credential resolution and
        the secrets CLI group)."""
        creds = self.configs.get("credentials", {}).get(
            "credentials", {})
        return ((creds.get("secrets") or {}).get("file"),
                (creds.get("gcp") or {}).get("project"))

    @property
    def credentials(self):
        # Secret indirection resolves lazily, on first credential use:
        # commands that never touch credentials must not fail (or pay
        # gcloud round trips) on secret:// values
        # (keyvault.parse_secret_ids analog).
        if self._resolved_credentials is None:
            raw = self.configs.get("credentials", {})
            from batch_shipyard_tpu_torch.utils import secrets
            secrets_file, project = self.secret_io
            self._resolved_credentials = (
                secrets.resolve_config_secrets(raw, secrets_file,
                                               project))
        return settings_mod.credentials_settings(
            self._resolved_credentials)

    @property
    def global_settings(self):
        return settings_mod.global_settings(self.configs.get("config", {}))

    @property
    def pool(self):
        if "pool" not in self.configs:
            raise ValueError("pool config not loaded (pass --configdir "
                             "with pool.yaml or --pool)")
        return settings_mod.pool_settings(self.configs["pool"])

    @property
    def jobs(self):
        if "jobs" not in self.configs:
            raise ValueError("jobs config not loaded")
        return settings_mod.job_settings_list(self.configs["jobs"])

    # --------------------------- clients -------------------------------

    @property
    def store(self) -> StateStore:
        if self._store is None:
            creds = self.credentials
            # Headless identity (federation proxy VM, monitor VM,
            # slurm controller): activate the configured service
            # account before ANY cloud client is constructed.
            from batch_shipyard_tpu_torch.utils import auth
            auth.ensure_service_account(creds.gcp)
            self._store = create_statestore(creds.storage)
        return self._store

    def substrate(self, pool=None) -> ComputeSubstrate:
        pool = pool or self.pool
        kind = pool.substrate
        if kind not in self._substrates:
            from batch_shipyard_tpu_torch.utils import auth
            auth.ensure_service_account(self.credentials.gcp)
            kwargs = dict(self.substrate_kwargs.get(kind, {}))
            if kind == "localhost":
                kwargs.setdefault("pool_config", self.configs.get("pool"))
            self._substrates[kind] = create_substrate(
                kind, self.store, self.credentials, **kwargs)
        return self._substrates[kind]


def load_context(configdir: Optional[str] = None,
                 config_files: Optional[dict[str, str]] = None,
                 extra: Optional[dict[str, dict]] = None) -> Context:
    """Load + strictly validate every present config file
    (CliContext._init_config analog, --configdir convention
    shipyard.py:804)."""
    configs: dict[str, dict] = {}
    if configdir:
        base = pathlib.Path(configdir)
        for name in _CONFIG_TYPES:
            for suffix in (".yaml", ".yml", ".json"):
                path = base / f"{name}{suffix}"
                if path.exists():
                    with open(path, "r", encoding="utf-8") as fh:
                        configs[name] = yaml.safe_load(fh) or {}
                    break
    for name, path in (config_files or {}).items():
        with open(path, "r", encoding="utf-8") as fh:
            configs[name] = yaml.safe_load(fh) or {}
    for name, data in (extra or {}).items():
        configs[name] = data
    for name, data in configs.items():
        validate_config(_CONFIG_TYPES[name], data)
    return Context(configs=configs)


def _emit(payload: Any, raw: bool = False) -> None:
    if raw:
        sys.stdout.write(json.dumps(payload, indent=2, default=str) + "\n")
    else:
        yaml.safe_dump(payload, sys.stdout, default_flow_style=False,
                       sort_keys=False)


# ------------------------------ pool actions ---------------------------

def action_pool_add(ctx: Context, wait: bool = True,
                    quota_client=None) -> list:
    """pool add (fleet.py:3390 analog), preceded by the advisory
    quota/capacity preflight (``_quota_preflight``)."""
    pool = ctx.pool
    for warning in _quota_preflight(ctx, quota_client):
        logger.warning("pool add preflight: %s", warning)
    nodes = pool_mgr.create_pool(
        ctx.store, ctx.substrate(), pool, ctx.global_settings,
        ctx.configs.get("pool"), wait=wait)
    logger.info("pool %s ready with %d nodes", pool.id, len(nodes))
    return nodes


def _quota_preflight(ctx: Context, quota_client=None) -> list[str]:
    """Advisory quota warnings before a cloud (``tpu_vm``) pool's
    allocation, from the GPU quota client (substrate/quota.py); [] for
    every other substrate. Never raises, never blocks."""
    pool = ctx.pool
    if pool.substrate != "tpu_vm":
        return []
    try:
        from batch_shipyard_tpu_torch.substrate import quota as quota_mod
        if quota_client is None:
            import shutil as shutil_mod
            if shutil_mod.which("gcloud") is None or \
                    ctx.credentials.gcp is None:
                return []
            quota_client = quota_mod.GpuQuotaClient(
                ctx.credentials.gcp.project)
        zone = pool.zone or (ctx.credentials.gcp.zone
                             if ctx.credentials.gcp else None)
        return quota_mod.preflight_pool(pool, quota_client, zone=zone)
    except Exception as exc:  # noqa: BLE001 - advisory only
        logger.debug("quota preflight skipped: %s", exc)
        return []


def action_pool_list(ctx: Context, raw: bool = False) -> None:
    pools = [{"id": p["_rk"], "state": p.get("state"),
              "created_at": p.get("created_at")}
             for p in pool_mgr.list_pools(ctx.store)]
    _emit({"pools": pools}, raw)


def action_pool_del(ctx: Context, pool_id: Optional[str] = None) -> None:
    pool_id = pool_id or ctx.pool.id
    pool_mgr.delete_pool(ctx.store, ctx.substrate(), pool_id)
    logger.info("pool %s deleted", pool_id)


def action_pool_resize(ctx: Context, num_slices: int,
                       wait: bool = True) -> None:
    pool_mgr.resize_pool(ctx.store, ctx.substrate(), ctx.pool,
                         num_slices, wait=wait)


def action_pool_nodes_list(ctx: Context, raw: bool = False) -> None:
    nodes = [dataclasses.asdict(n)
             for n in pool_mgr.list_nodes(ctx.store, ctx.pool.id)]
    _emit({"nodes": nodes}, raw)


def action_pool_stats(ctx: Context, raw: bool = False) -> None:
    _emit(pool_mgr.pool_stats(ctx.store, ctx.pool.id), raw)


def action_pool_nodes_count(ctx: Context, raw: bool = False) -> None:
    """Node-state histogram (reference shipyard.py:1868)."""
    _emit(pool_mgr.node_counts(ctx.store, ctx.pool.id), raw)


def action_pool_nodes_grls(ctx: Context,
                           node_id: Optional[str] = None,
                           raw: bool = False) -> None:
    """Remote-login settings for node(s) (reference
    convoy/batch.py:3074)."""
    _emit({"remote_login": pool_mgr.remote_login_settings(
        ctx.store, ctx.substrate(), ctx.pool.id, node_id)}, raw)


def action_pool_nodes_ps(ctx: Context,
                         node_id: Optional[str] = None,
                         raw: bool = False) -> None:
    """Running tasks/containers per node via the agent control
    channel (reference docker-ps-over-ssh, convoy/fleet.py:2468)."""
    # Fake-substrate agents live in-process: revive them so the
    # request/reply verbs have someone listening (no-op on real
    # substrates, whose agents run on the nodes).
    ctx.substrate().ensure_attached(ctx.pool)
    _emit({"nodes": pool_mgr.nodes_ps(ctx.store, ctx.pool.id,
                                      node_id)}, raw)


def action_pool_nodes_zap(ctx: Context,
                          node_id: Optional[str] = None,
                          raw: bool = False) -> None:
    """Kill all live task processes/containers on node(s)
    (reference shipyard.py:1906)."""
    ctx.substrate().ensure_attached(ctx.pool)
    _emit({"nodes": pool_mgr.nodes_zap(ctx.store, ctx.pool.id,
                                       node_id)}, raw)


def action_pool_nodes_prune(ctx: Context,
                            node_id: Optional[str] = None,
                            raw: bool = False) -> None:
    """Prune unreferenced image-cache entries on node(s)
    (reference shipyard.py:1919)."""
    ctx.substrate().ensure_attached(ctx.pool)
    _emit({"nodes": pool_mgr.nodes_prune(ctx.store, ctx.pool.id,
                                         node_id)}, raw)


def action_pool_nodes_reboot(ctx: Context, node_id: str) -> None:
    """Reboot a node by recreating its slice (reference
    shipyard.py:1882; a GPU pool is one slice of its nodes)."""
    s = pool_mgr.reboot_node(ctx.store, ctx.substrate(), ctx.pool,
                             node_id)
    _emit({"node_id": node_id, "recreated_slice": s})


def action_pool_nodes_del(ctx: Context, node_id: str) -> None:
    """Delete a node by deallocating its slice without replacement
    (reference shipyard.py:1795)."""
    s = pool_mgr.delete_node(ctx.store, ctx.substrate(), ctx.pool,
                             node_id)
    _emit({"node_id": node_id, "deallocated_slice": s})


def action_pool_ssh(ctx: Context, node_id: str) -> Optional[tuple]:
    login = ctx.substrate().get_remote_login(ctx.pool.id, node_id)
    if login is None:
        logger.error("no remote login for %s", node_id)
        return None
    _emit({"node": node_id, "ip": login[0], "port": login[1]})
    return login


def action_pool_images_update(ctx: Context, image: str,
                              kind: str = "docker") -> None:
    """Force image (re)load on all nodes (fleet.py:2241 analog)."""
    for node in pool_mgr.list_nodes(ctx.store, ctx.pool.id):
        pool_mgr.send_control(ctx.store, ctx.pool.id, node.node_id, {
            "type": "load_images", "images": [image], "kind": kind})


def action_pool_suspend(ctx: Context) -> None:
    pool = ctx.pool
    ctx.substrate().suspend_pool(pool)
    ctx.store.merge_entity(names.TABLE_POOLS, "pools", pool.id,
                           {"state": "suspended"})
    logger.info("pool %s suspended", pool.id)


def action_pool_start(ctx: Context) -> None:
    pool = ctx.pool
    ctx.substrate().start_pool(pool)
    nodes = pool_mgr.wait_for_pool_ready(ctx.store, ctx.substrate(),
                                         pool)
    ctx.store.merge_entity(names.TABLE_POOLS, "pools", pool.id,
                           {"state": "ready"})
    logger.info("pool %s started with %d nodes", pool.id, len(nodes))


def action_pool_user_add(ctx: Context, username: str,
                         output_dir: str = ".") -> tuple[str, str]:
    """Generate a keypair and install the public key on every node
    (pool user add analog, batch.py:1045)."""
    from batch_shipyard_tpu_torch.utils import crypto
    private_path, public_path = crypto.generate_ssh_keypair(
        output_dir, name=f"id_rsa_shipyard_{ctx.pool.id}")
    with open(public_path, "r", encoding="utf-8") as fh:
        public_key = fh.read().strip()
    for node in pool_mgr.list_nodes(ctx.store, ctx.pool.id):
        pool_mgr.send_control(ctx.store, ctx.pool.id, node.node_id, {
            "type": "install_ssh_key", "username": username,
            "public_key": public_key})
    logger.info("ssh key %s fanned out to pool %s", public_path,
                ctx.pool.id)
    return private_path, public_path


def action_pool_user_del(ctx: Context, username: str) -> None:
    for node in pool_mgr.list_nodes(ctx.store, ctx.pool.id):
        pool_mgr.send_control(ctx.store, ctx.pool.id, node.node_id, {
            "type": "remove_ssh_user", "username": username})


def action_diag_logs_upload(ctx: Context) -> int:
    """Ask every node to ship its logs to the object store
    (diag logs upload analog, batch.py:3151)."""
    count = 0
    for node in pool_mgr.list_nodes(ctx.store, ctx.pool.id):
        pool_mgr.send_control(ctx.store, ctx.pool.id, node.node_id,
                              {"type": "upload_logs"})
        count += 1
    return count


def action_account_info(ctx: Context, raw: bool = False) -> None:
    """Account/environment summary (account info/quota analog,
    shipyard.py:1009)."""
    creds = ctx.credentials
    info: dict = {
        "storage_backend": creds.storage.backend,
        "storage_prefix": creds.storage.prefix,
        "gcp_project": creds.gcp.project if creds.gcp else None,
        "pools": [p["_rk"] for p in pool_mgr.list_pools(ctx.store)],
    }
    # Subprocess probe with a hard timeout: a wedged GPU must yield
    # an honest "unreachable" here, not a hung CLI (an in-process
    # CUDA device query can BLOCK, not fail).
    from batch_shipyard_tpu_torch.utils.util import probe_default_devices
    count, reason = probe_default_devices(timeout=30.0)
    info["local_accelerator_count"] = count
    if reason:
        info["local_accelerator_error"] = reason
    _emit(info, raw)


# ------------------------------ job actions ----------------------------

def _submit_auto_pool_job(ctx: Context, job) -> dict:
    """Provision a dedicated pool for one job and submit the job to it
    (reference _construct_auto_pool_specification, fleet.py:1768: pool
    lifetime tied to the job). The pool spec is the configured pool
    with a derived id; action_autopool_reap (or the CLI's
    `jobs autopool-reap`) deletes it once the job completes."""
    import copy

    auto_id = f"{job.id}-autopool"
    conf = copy.deepcopy(ctx.configs.get("pool"))
    conf["pool_specification"]["id"] = auto_id
    auto_pool = settings_mod.pool_settings(conf)
    substrate = ctx.substrate(auto_pool)
    create_exc: Optional[BaseException] = None
    try:
        pool_mgr.create_pool(ctx.store, substrate, auto_pool,
                             ctx.global_settings, conf)
    except BaseException as exc:
        create_exc = exc
        raise
    finally:
        # Mark even on a failed/timed-out create (the record is
        # inserted before allocation): a half-created auto pool must
        # stay reapable, never a leaked allocation. The bookkeeping
        # must not mask an in-flight create_pool exception — but on
        # the success path a marking failure MUST surface (an
        # unmarked pool would silently leak).
        try:
            if pool_mgr.pool_exists(ctx.store, auto_id):
                ctx.store.merge_entity(names.TABLE_POOLS, "pools",
                                       auto_id, {
                    "auto_pool_for": job.id,
                    "auto_pool_keep_alive": bool(
                        (job.auto_pool or {}).get("keep_alive",
                                                  False)),
                })
        except Exception:  # noqa: BLE001
            logger.exception(
                "failed to mark auto pool %s reapable", auto_id)
            if create_exc is None:
                raise
    if not job.auto_complete:
        # The pool's lifetime is the job's: the job must be able to
        # reach a completed state on its own.
        job = dataclasses.replace(job, auto_complete=True)
    # Override any job-level pool_id: an auto_pool job lives on its
    # derived pool by definition.
    return jobs_mgr.add_jobs(ctx.store, auto_pool, [job],
                             pool_id_override=auto_id)


def action_autopool_reap(ctx: Context) -> list[str]:
    """Delete auto pools whose job completed (keep_alive pools are
    left). Run after jobs finish or periodically."""
    reaped = []
    for rec in pool_mgr.list_pools(ctx.store):
        job_id = rec.get("auto_pool_for")
        if not job_id or rec.get("auto_pool_keep_alive"):
            continue
        pool_id = rec["_rk"]
        try:
            job = jobs_mgr.get_job(ctx.store, pool_id, job_id)
        except jobs_mgr.JobNotFoundError:
            # Job record deleted: the pool has nothing to live for.
            # (Transient store errors must propagate — never treat
            # them as "completed" and delete a live pool.)
            job = {"state": "completed"}
        if job.get("state") == "completed":
            spec = rec.get("spec", {}).get("pool_specification", {})
            kind_pool = settings_mod.pool_settings(rec.get("spec", {})) \
                if spec else ctx.pool
            pool_mgr.delete_pool(ctx.store, ctx.substrate(kind_pool),
                                 pool_id)
            reaped.append(pool_id)
            logger.info("auto pool %s reaped (job %s completed)",
                        pool_id, job_id)
    return reaped


def action_jobs_add(ctx: Context, tail: Optional[str] = None) -> dict:
    """jobs add (fleet.py:4000 analog). tail: stream the given file of
    the last task submitted (reference --tail)."""
    pool = ctx.pool
    # Recurrence-bearing jobs REGISTER as pool schedules (fired by the
    # pool-resident scheduler or `jobs schedule`) instead of running
    # once immediately — the reference's JobScheduleAdd split.
    recurrent = [j for j in ctx.jobs if j.recurrence is not None]
    if recurrent:
        from batch_shipyard_tpu_torch.jobs import schedules
        registered = schedules.register_schedules(
            ctx.store, pool.id, ctx.configs["jobs"])
        logger.info("registered schedules %s", registered)
    regular = [j for j in ctx.jobs
               if not j.auto_pool and j.recurrence is None]
    submitted = {}
    for job in ctx.jobs:
        if job.auto_pool and job.recurrence is None:
            submitted.update(_submit_auto_pool_job(ctx, job))
    if regular:
        ctx.substrate().ensure_attached(pool)
        submitted.update(jobs_mgr.add_jobs(ctx.store, pool, regular))
    logger.info("submitted %s", submitted)
    if tail:
        job = ctx.jobs[-1]
        tail_pool = (f"{job.id}-autopool" if job.auto_pool
                     else pool.id)
        tasks = jobs_mgr.list_tasks(ctx.store, tail_pool, job.id)
        if tasks:
            last = sorted(t["_rk"] for t in tasks)[-1]
            for chunk in jobs_mgr.stream_task_output(
                    ctx.store, tail_pool, job.id, last, filename=tail):
                sys.stdout.write(chunk.decode(errors="replace"))
                sys.stdout.flush()
    return submitted


def action_jobs_list(ctx: Context, raw: bool = False) -> None:
    jobs = [{"id": j["_rk"], "state": j.get("state")}
            for j in jobs_mgr.list_jobs(ctx.store, ctx.pool.id)]
    _emit({"jobs": jobs}, raw)


def action_jobs_tasks_list(ctx: Context, job_id: str,
                           raw: bool = False) -> None:
    from batch_shipyard_tpu_torch.trace import context as trace_ctx
    from batch_shipyard_tpu_torch.trace import profiling as trace_prof
    tasks = []
    for t in jobs_mgr.list_tasks(ctx.store, ctx.pool.id, job_id):
        row = {"id": t["_rk"], "state": t.get("state"),
               "exit_code": t.get("exit_code"),
               "node_id": t.get("node_id")}
        # The submission's trace id: the handle `shipyard trace
        # show|export` takes (absent on legacy pre-trace rows).
        if t.get(trace_ctx.COL_TRACE_ID):
            row["trace_id"] = t.get(trace_ctx.COL_TRACE_ID)
        # On-demand profiling artifact, next to the diagnostics
        # column: the object-store prefix the capture uploaded to.
        if t.get(trace_prof.COL_PROFILE_ARTIFACT):
            row["profile_artifact"] = t.get(
                trace_prof.COL_PROFILE_ARTIFACT)
        if t.get("retries"):
            row["retries"] = t.get("retries")
        if t.get("wedged"):
            row["wedged"] = True
        # Poison quarantine surfaces its post-mortem right here: the
        # retry supervisor's diagnostics bundle (stderr tail, node /
        # exit-code history) so the operator never greps node logs.
        if t.get("state") == names.TASK_STATE_QUARANTINED:
            row["error"] = t.get("error")
            diag = dict(t.get("diagnostics") or {})
            history = diag.get("attempt_history") or []
            if history:
                # Operator-friendly projections of attempt_history
                # (the entity stores only the one source of truth).
                diag["node_history"] = [a.get("node_id")
                                        for a in history]
                diag["exit_codes"] = [a.get("exit_code")
                                      for a in history]
            row["diagnostics"] = diag
        tasks.append(row)
    _emit({"tasks": tasks}, raw)


def action_jobs_term(ctx: Context, job_id: Optional[str] = None,
                     wait: bool = False) -> None:
    for job in ([job_id] if job_id else [j.id for j in ctx.jobs]):
        jobs_mgr.terminate_job(ctx.store, ctx.pool.id, job, wait=wait)


def action_jobs_del(ctx: Context, job_id: Optional[str] = None) -> None:
    for job in ([job_id] if job_id else [j.id for j in ctx.jobs]):
        jobs_mgr.delete_job(ctx.store, ctx.pool.id, job)


def action_jobs_stats(ctx: Context, job_id: Optional[str] = None,
                      raw: bool = False) -> None:
    _emit(jobs_mgr.job_stats(ctx.store, ctx.pool.id, job_id), raw)


def action_jobs_wait(ctx: Context, job_id: str,
                     timeout: float = 600.0,
                     goodput_report: bool = False,
                     raw: bool = False) -> list[dict]:
    """Block until every task of a job is terminal; optionally follow
    with the job's goodput decomposition (--goodput-report)."""
    ctx.substrate().ensure_attached(ctx.pool)
    tasks = jobs_mgr.wait_for_tasks(ctx.store, ctx.pool.id, job_id,
                                    timeout=timeout)
    _emit({"tasks": [{"id": t["_rk"], "state": t.get("state"),
                      "exit_code": t.get("exit_code")}
                     for t in tasks]}, raw)
    if goodput_report:
        action_goodput(ctx, "job", job_id=job_id, raw=raw)
    return tasks


# ---------------------------- compile cache ----------------------------

def action_pool_cache_stats(ctx: Context, raw: bool = False) -> dict:
    """Seed-artifact state of the pool's warm-start compile cache
    (compilecache/seeding.py): latest identity/entries/bytes plus the
    stored artifact list."""
    from batch_shipyard_tpu_torch.compilecache import seeding
    report = seeding.stats(ctx.store, ctx.pool.id)
    _emit(report, raw)
    return report


def action_pool_cache_seed(ctx: Context, cache_dir: str,
                           raw: bool = False) -> str:
    """Seed a LOCAL cache dir from the pool artifact (the node
    agents seed themselves before each task; this verb serves dev
    boxes and pre-bake pipelines). Refuses a mismatched identity."""
    from batch_shipyard_tpu_torch.compilecache import seeding
    status = seeding.seed_cache(ctx.store, ctx.pool.id, cache_dir)
    _emit({"pool_id": ctx.pool.id, "cache_dir": cache_dir,
           "status": status,
           "seeded": status == seeding.SEEDED}, raw)
    return status


def action_pool_cache_prune(ctx: Context, raw: bool = False) -> int:
    """Drop the pool's cache artifacts (the stale-cache escape hatch:
    after a torch/CUDA upgrade or model change the old seed can only
    miss — see docs/17-troubleshooting.md)."""
    from batch_shipyard_tpu_torch.compilecache import seeding
    removed = seeding.prune(ctx.store, ctx.pool.id)
    _emit({"pool_id": ctx.pool.id, "removed": removed}, raw)
    return removed


# ------------------------------- tracing -------------------------------

def action_jobs_profile(ctx: Context, job_id: str,
                        steps: int = 10) -> dict:
    """`jobs profile`: stamp an on-demand profiling request on the
    job entity. Node agents forward it to the job's tasks (at launch
    and, via the heartbeat loop, to already-running ones); the train
    harness wraps the next N steps in torch.profiler and the
    agent uploads the artifact next to the task's diagnostics."""
    from batch_shipyard_tpu_torch.trace import profiling as trace_prof
    jobs_mgr.get_job(ctx.store, ctx.pool.id, job_id)  # must exist
    request = {"steps": int(steps),
               "requested_at": util.datetime_utcnow_iso()}
    ctx.store.merge_entity(
        names.TABLE_JOBS, ctx.pool.id, job_id,
        {trace_prof.COL_PROFILE_REQUEST: request})
    logger.info("profile request (%d steps) stamped on job %s",
                steps, job_id)
    _emit({"job_id": job_id, "profile_request": request})
    return request


def action_jobs_preempt(ctx: Context, job_id: str, task_id: str,
                        reason: str = "") -> bool:
    """`jobs preempt`: stamp a cooperative preempt request on a
    running task (the preempt sweep's manual override). The owning
    node delivers it over the heartbeat path; an instrumented
    workload drains to its next step boundary, forces a COMMITTED
    checkpoint, and exits with the distinct preempted status —
    requeued at FULL retry budget, node health untouched."""
    ok = jobs_mgr.request_preemption(
        ctx.store, ctx.pool.id, job_id, task_id,
        reason=reason or "operator request (jobs preempt)")
    _emit({"job_id": job_id, "task_id": task_id, "requested": ok})
    if not ok:
        logger.warning("task %s/%s is not in a preemptible state",
                       job_id, task_id)
    return ok


def action_trace_show(ctx: Context, trace_id: str,
                      raw: bool = False) -> dict:
    """`trace show <trace_id>`: terminal waterfall of one
    submission's spans (+ its goodput intervals)."""
    from batch_shipyard_tpu_torch.trace import export as trace_export
    rows = trace_export.trace_rows(ctx.store, ctx.pool.id, trace_id)
    if raw:
        _emit(rows, raw=True)
    else:
        sys.stdout.write(trace_export.render_tree(rows) + "\n")
    return rows


def action_trace_export(ctx: Context, trace_id: str,
                        output: Optional[str] = None) -> dict:
    """`trace export <trace_id>`: Chrome trace-event JSON
    (chrome://tracing / ui.perfetto.dev loadable), to ``output`` or
    stdout."""
    from batch_shipyard_tpu_torch.trace import export as trace_export
    chrome = trace_export.export_trace(ctx.store, ctx.pool.id,
                                       trace_id)
    if output:
        trace_export.write_chrome_trace(chrome, output)
        logger.info("trace %s exported to %s (%d events)", trace_id,
                    output, len(chrome["traceEvents"]))
    else:
        sys.stdout.write(json.dumps(chrome, indent=2) + "\n")
    return chrome


# ------------------------------- goodput -------------------------------

def action_goodput(ctx: Context, scope: str,
                   job_id: Optional[str] = None,
                   raw: bool = False,
                   trace_id: Optional[str] = None) -> dict:
    """Goodput decomposition + badput waterfall for a job, the pool,
    or the whole fleet (goodput/accounting.py over TABLE_GOODPUT).
    ``trace_id`` (job scope only) restricts the waterfall to one
    submission's trace."""
    from batch_shipyard_tpu_torch.goodput import accounting
    if trace_id is not None and scope != "job":
        raise ValueError("--trace only applies to `goodput job`")
    if scope == "job":
        if not job_id:
            raise ValueError("goodput job requires a job id")
        report = accounting.job_report(ctx.store, ctx.pool.id, job_id,
                                       trace_id=trace_id)
    elif scope == "pool":
        report = accounting.pool_report(ctx.store, ctx.pool.id)
    elif scope == "fleet":
        report = accounting.fleet_report(ctx.store)
    else:
        raise ValueError(f"unknown goodput scope {scope!r}")
    if raw:
        _emit(report, raw=True)
    else:
        sys.stdout.write(accounting.waterfall_table(report) + "\n")
        if scope == "fleet":
            for pool_id in sorted(report.get("pools", {})):
                sys.stdout.write(
                    f"\n== pool {pool_id} ==\n"
                    + accounting.waterfall_table(
                        report["pools"][pool_id]) + "\n")
        elif scope == "pool":
            for jid in sorted(report.get("jobs", {})):
                sys.stdout.write(
                    f"\n== job {jid} ==\n"
                    + accounting.waterfall_table(
                        report["jobs"][jid]) + "\n")
    return report


def action_data_stream(ctx: Context, job_id: str, task_id: str,
                       filename: str = "stdout.txt") -> None:
    """data files stream (fleet.py action analog of batch.py:3243)."""
    ctx.substrate().ensure_attached(ctx.pool)
    for chunk in jobs_mgr.stream_task_output(
            ctx.store, ctx.pool.id, job_id, task_id, filename=filename):
        sys.stdout.write(chunk.decode(errors="replace"))
        sys.stdout.flush()


# ----------------------------- diagnostics -----------------------------

def action_perf_events(ctx: Context, raw: bool = False) -> None:
    from batch_shipyard_tpu_torch.agent import perf
    events = [{"t": e["timestamp"], "node": e["node_id"],
               "source": e["source"], "event": e["event"]}
              for e in perf.query(ctx.store, ctx.pool.id)]
    _emit({"events": events}, raw)
