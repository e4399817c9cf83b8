"""shipyard-tpu-torch CLI: the click command tree.

The port's copy of batch_shipyard_tpu/cli/main.py, with the same groups,
verbs, option names and output (YAML, or JSON under ``--raw``, through
``fleet._emit``), over the port's fleet layer. Reference analog:
shipyard.py (3136 LoC click tree: pool/jobs/data/storage/diag/monitor/
fed/slurm groups, shipyard.py:1001-3136). Groups mirror the reference
so a Batch Shipyard user finds the same verbs:

  shipyard-tpu-torch pool   add | list | del | resize | nodes | stats |
                            ssh | cache | user | images | autoscale ...
  shipyard-tpu-torch jobs   add | list | term | del | stats | wait |
                            tasks list
  shipyard-tpu-torch goodput job | pool | fleet
  shipyard-tpu-torch trace  show | export | prune
  shipyard-tpu-torch data   stream | files | ingress
  shipyard-tpu-torch diag   perf | logs | gantt
  shipyard-tpu-torch account info | quota
  shipyard-tpu-torch secrets / storage

Not here yet, so click answers "No such command": lint, chaos, sim,
monitor, fed, slurm, fs and misc (their modules are not ported).
Importing this module loads no torch.
"""

from __future__ import annotations

import os
import sys

import click

from batch_shipyard_tpu_torch import fleet
from batch_shipyard_tpu_torch.version import __version__


@click.group(context_settings={"help_option_names": ["-h", "--help"]})
@click.version_option(version=__version__)
@click.option("--configdir", envvar="SHIPYARD_CONFIGDIR", default=None,
              help="Directory holding credentials/config/pool/jobs yaml")
@click.option("--credentials", "credentials_path", default=None,
              help="Path to credentials yaml")
@click.option("--config", "config_path", default=None,
              help="Path to global config yaml")
@click.option("--pool", "pool_path", default=None,
              help="Path to pool yaml")
@click.option("--jobs", "jobs_path", default=None,
              help="Path to jobs yaml")
@click.option("--raw", is_flag=True, default=False,
              help="JSON output for scripting")
@click.pass_context
def cli(click_ctx, configdir, credentials_path, config_path, pool_path,
        jobs_path, raw):
    files = {}
    if credentials_path:
        files["credentials"] = credentials_path
    if config_path:
        files["config"] = config_path
    if pool_path:
        files["pool"] = pool_path
    if jobs_path:
        files["jobs"] = jobs_path
    click_ctx.obj = {
        "configdir": configdir, "files": files, "raw": raw, "ctx": None}


def _ctx(click_ctx) -> fleet.Context:
    if click_ctx.obj["ctx"] is None:
        click_ctx.obj["ctx"] = fleet.load_context(
            click_ctx.obj["configdir"], click_ctx.obj["files"])
    return click_ctx.obj["ctx"]


# ------------------------------- pool ----------------------------------

@cli.group()
def pool():
    """Pool lifecycle (GPU node pools)."""


@pool.command("add")
@click.option("--no-wait", is_flag=True, default=False)
@click.pass_context
def pool_add(click_ctx, no_wait):
    """Provision the pool from pool.yaml."""
    fleet.action_pool_add(_ctx(click_ctx), wait=not no_wait)


@pool.command("list")
@click.pass_context
def pool_list(click_ctx):
    fleet.action_pool_list(_ctx(click_ctx), raw=click_ctx.obj["raw"])


@pool.command("del")
@click.option("--pool-id", default=None)
@click.option("-y", "--yes", is_flag=True, default=False)
@click.pass_context
def pool_del(click_ctx, pool_id, yes):
    ctx = _ctx(click_ctx)
    target = pool_id or ctx.pool.id
    if not yes and not click.confirm(
            f"Delete pool {target} and all its jobs/tasks?"):
        raise click.Abort()
    fleet.action_pool_del(ctx, pool_id)


@pool.command("resize")
@click.argument("num_slices", type=int)
@click.pass_context
def pool_resize(click_ctx, num_slices):
    fleet.action_pool_resize(_ctx(click_ctx), num_slices)


@pool.command("exists")
@click.option("--pool-id", default=None)
@click.pass_context
def pool_exists(click_ctx, pool_id):
    """Exit 0 if the pool exists, 1 otherwise (reference
    `pool exists`)."""
    from batch_shipyard_tpu_torch.pool import manager as pool_mgr
    ctx = _ctx(click_ctx)
    target = pool_id or ctx.pool.id
    if pool_mgr.pool_exists(ctx.store, target):
        click.echo(f"pool {target} exists")
    else:
        click.echo(f"pool {target} does not exist")
        raise SystemExit(1)


@pool.command("stats")
@click.pass_context
def pool_stats(click_ctx):
    fleet.action_pool_stats(_ctx(click_ctx), raw=click_ctx.obj["raw"])


@pool.group()
def nodes():
    """Node operations."""


@nodes.command("list")
@click.pass_context
def pool_nodes_list(click_ctx):
    fleet.action_pool_nodes_list(_ctx(click_ctx),
                                 raw=click_ctx.obj["raw"])


@nodes.command("count")
@click.pass_context
def pool_nodes_count(click_ctx):
    """Node-state histogram (reference `pool nodes count`)."""
    fleet.action_pool_nodes_count(_ctx(click_ctx),
                                  raw=click_ctx.obj["raw"])


@nodes.command("grls")
@click.option("--node-id", default=None)
@click.pass_context
def pool_nodes_grls(click_ctx, node_id):
    """Remote-login settings (ip/port) for nodes (reference
    `pool nodes grls`)."""
    fleet.action_pool_nodes_grls(_ctx(click_ctx), node_id,
                                 raw=click_ctx.obj["raw"])


@nodes.command("ps")
@click.option("--node-id", default=None)
@click.pass_context
def pool_nodes_ps(click_ctx, node_id):
    """List running tasks/containers on nodes (reference
    `pool nodes ps`)."""
    fleet.action_pool_nodes_ps(_ctx(click_ctx), node_id,
                               raw=click_ctx.obj["raw"])


@nodes.command("zap")
@click.option("--node-id", default=None)
@click.option("-y", "--yes", is_flag=True)
@click.pass_context
def pool_nodes_zap(click_ctx, node_id, yes):
    """Kill all live task processes/containers on nodes (reference
    `pool nodes zap`)."""
    if not yes:
        click.confirm(
            f"zap all running work on "
            f"{node_id or 'ALL nodes'}?", abort=True)
    fleet.action_pool_nodes_zap(_ctx(click_ctx), node_id,
                                raw=click_ctx.obj["raw"])


@nodes.command("prune")
@click.option("--node-id", default=None)
@click.pass_context
def pool_nodes_prune(click_ctx, node_id):
    """Prune unreferenced image-cache entries on nodes (reference
    `pool nodes prune`)."""
    fleet.action_pool_nodes_prune(_ctx(click_ctx), node_id,
                                  raw=click_ctx.obj["raw"])


@nodes.command("reboot")
@click.argument("node_id")
@click.option("-y", "--yes", is_flag=True)
@click.pass_context
def pool_nodes_reboot(click_ctx, node_id, yes):
    """Reboot a node (recreates its pool's slice; reference
    `pool nodes reboot`)."""
    if not yes:
        click.confirm(f"reboot {node_id}'s slice?", abort=True)
    fleet.action_pool_nodes_reboot(_ctx(click_ctx), node_id)


@nodes.command("del")
@click.argument("node_id")
@click.option("-y", "--yes", is_flag=True)
@click.pass_context
def pool_nodes_del(click_ctx, node_id, yes):
    """Delete a node (deallocates its pool's slice without
    replacement; reference `pool nodes del`)."""
    if not yes:
        click.confirm(f"deallocate {node_id}'s slice?", abort=True)
    fleet.action_pool_nodes_del(_ctx(click_ctx), node_id)


@pool.command("ssh")
@click.argument("node_id")
@click.pass_context
def pool_ssh(click_ctx, node_id):
    fleet.action_pool_ssh(_ctx(click_ctx), node_id)


@pool.command("suspend")
@click.pass_context
def pool_suspend(click_ctx):
    """Stop the pool's machines without deleting the pool."""
    fleet.action_pool_suspend(_ctx(click_ctx))


@pool.command("start")
@click.pass_context
def pool_start(click_ctx):
    """Restart a suspended pool."""
    fleet.action_pool_start(_ctx(click_ctx))


@pool.group("cache")
def pool_cache():
    """Warm-start compile-cache seeding (docs/29-compile-cache.md)."""


@pool_cache.command("stats")
@click.pass_context
def pool_cache_stats(click_ctx):
    """Seed-artifact state: identity, entries, bytes, uploader."""
    fleet.action_pool_cache_stats(_ctx(click_ctx),
                                  raw=click_ctx.obj["raw"])


@pool_cache.command("seed")
@click.option("--cache-dir",
              default=os.environ.get("SHIPYARD_COMPILE_CACHE_DIR")
              or "./compilecache", show_default=True,
              help="local cache dir to seed from the pool artifact")
@click.pass_context
def pool_cache_seed(click_ctx, cache_dir):
    """Seed a local cache dir from the pool's artifact (refuses a
    mismatched cache identity)."""
    fleet.action_pool_cache_seed(_ctx(click_ctx), cache_dir,
                                 raw=click_ctx.obj["raw"])


@pool_cache.command("prune")
@click.option("-y", "--yes", is_flag=True)
@click.pass_context
def pool_cache_prune(click_ctx, yes):
    """Delete the pool's compile-cache artifacts (stale-cache escape
    hatch after torch/CUDA or model upgrades)."""
    if not yes:
        click.confirm("prune the pool's compile-cache artifacts?",
                      abort=True)
    fleet.action_pool_cache_prune(_ctx(click_ctx),
                                  raw=click_ctx.obj["raw"])


@pool.group()
def user():
    """SSH user management on pool nodes."""


@user.command("add")
@click.option("--username", default="shipyard")
@click.option("--output-dir", default=".")
@click.pass_context
def pool_user_add(click_ctx, username, output_dir):
    private_path, _public = fleet.action_pool_user_add(
        _ctx(click_ctx), username, output_dir)
    click.echo(f"private key: {private_path}")


@user.command("del")
@click.option("--username", default="shipyard")
@click.pass_context
def pool_user_del(click_ctx, username):
    fleet.action_pool_user_del(_ctx(click_ctx), username)


@pool.group()
def images():
    """Container image management on pool nodes."""


@images.command("list")
@click.pass_context
def pool_images_list(click_ctx):
    """List the pool's replicated image manifest."""
    ctx = _ctx(click_ctx)
    from batch_shipyard_tpu_torch.state import names as names_mod
    images = []
    registries = []
    for r in ctx.store.query_entities(names_mod.TABLE_IMAGES,
                                      partition_key=ctx.pool.id):
        if r.get("kind") == "registry":
            # Credential rows ride the same manifest; list them as a
            # separate section (never their secret material).
            registries.append({"server": r.get("server")})
        else:
            images.append({"kind": r.get("kind"),
                           "image": r.get("image")})
    fleet._emit({"images": images, "registries": registries},
                click_ctx.obj["raw"])


@images.command("update")
@click.argument("image")
@click.option("--kind", default="docker",
              type=click.Choice(["docker", "singularity"]))
@click.pass_context
def pool_images_update(click_ctx, image, kind):
    fleet.action_pool_images_update(_ctx(click_ctx), image, kind)


@pool.group()
def autoscale():
    """Pool autoscale management."""


@autoscale.command("enable")
@click.pass_context
def pool_autoscale_enable(click_ctx):
    from batch_shipyard_tpu_torch.pool import autoscale as as_mod
    as_mod.enable_autoscale(_ctx(click_ctx).store, _ctx(click_ctx).pool)


@autoscale.command("disable")
@click.pass_context
def pool_autoscale_disable(click_ctx):
    from batch_shipyard_tpu_torch.pool import autoscale as as_mod
    as_mod.disable_autoscale(_ctx(click_ctx).store, _ctx(click_ctx).pool)


@autoscale.command("evaluate")
@click.pass_context
def pool_autoscale_evaluate(click_ctx):
    from batch_shipyard_tpu_torch.pool import autoscale as as_mod
    ctx = _ctx(click_ctx)
    decision = as_mod.evaluate(ctx.store, ctx.pool)
    fleet._emit(decision, click_ctx.obj["raw"])


@autoscale.command("tick")
@click.option("--daemon", is_flag=True, default=False,
              help="Loop at autoscale.evaluation_interval_seconds")
@click.option("--interval", type=float, default=None,
              help="Override evaluation interval seconds")
@click.pass_context
def pool_autoscale_tick(click_ctx, daemon, interval):
    """Evaluate AND apply the autoscale decision (the hosted
    evaluator's job in the reference)."""
    from batch_shipyard_tpu_torch.pool import autoscale as as_mod
    ctx = _ctx(click_ctx)
    if daemon:
        as_mod.run_daemon(ctx.store, ctx.substrate(), ctx.pool,
                          interval=interval)
    else:
        decision = as_mod.autoscale_tick(ctx.store, ctx.substrate(),
                                         ctx.pool)
        fleet._emit(decision, click_ctx.obj["raw"])


# ------------------------------- jobs ----------------------------------

@cli.group()
def jobs():
    """Job and task submission."""


@jobs.command("add")
@click.option("--tail", default=None,
              help="Stream this file of the last task after submit")
@click.pass_context
def jobs_add(click_ctx, tail):
    fleet.action_jobs_add(_ctx(click_ctx), tail=tail)


@jobs.command("autopool-reap")
@click.pass_context
def jobs_autopool_reap(click_ctx):
    """Delete auto pools whose job has completed."""
    reaped = fleet.action_autopool_reap(_ctx(click_ctx))
    click.echo(f"reaped: {reaped}")


@jobs.command("list")
@click.pass_context
def jobs_list(click_ctx):
    fleet.action_jobs_list(_ctx(click_ctx), raw=click_ctx.obj["raw"])


@jobs.command("term")
@click.option("--job-id", default=None)
@click.pass_context
def jobs_term(click_ctx, job_id):
    fleet.action_jobs_term(_ctx(click_ctx), job_id)


@jobs.command("del")
@click.option("--job-id", default=None)
@click.pass_context
def jobs_del(click_ctx, job_id):
    fleet.action_jobs_del(_ctx(click_ctx), job_id)


@jobs.command("stats")
@click.option("--job-id", default=None)
@click.pass_context
def jobs_stats(click_ctx, job_id):
    fleet.action_jobs_stats(_ctx(click_ctx), job_id,
                            raw=click_ctx.obj["raw"])


@jobs.command("wait")
@click.option("--job-id", required=True)
@click.option("--timeout", type=float, default=600.0)
@click.option("--goodput-report", is_flag=True, default=False,
              help="Print the job's goodput decomposition once all "
                   "tasks are terminal")
@click.pass_context
def jobs_wait(click_ctx, job_id, timeout, goodput_report):
    """Block until every task of a job is terminal."""
    try:
        fleet.action_jobs_wait(_ctx(click_ctx), job_id,
                               timeout=timeout,
                               goodput_report=goodput_report,
                               raw=click_ctx.obj["raw"])
    except TimeoutError as exc:
        raise click.ClickException(str(exc))


@jobs.command("disable")
@click.option("--job-id", required=True)
@click.pass_context
def jobs_disable(click_ctx, job_id):
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    ctx = _ctx(click_ctx)
    jobs_mgr.disable_job(ctx.store, ctx.pool.id, job_id)


@jobs.command("enable")
@click.option("--job-id", required=True)
@click.pass_context
def jobs_enable(click_ctx, job_id):
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    ctx = _ctx(click_ctx)
    jobs_mgr.enable_job(ctx.store, ctx.pool.id, job_id)


@jobs.command("migrate")
@click.option("--job-id", required=True)
@click.option("--dst-pool-id", required=True)
@click.pass_context
def jobs_migrate(click_ctx, job_id, dst_pool_id):
    """Move a job's pending tasks to another pool."""
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    ctx = _ctx(click_ctx)
    moved = jobs_mgr.migrate_job(ctx.store, ctx.pool.id, job_id,
                                 dst_pool_id)
    click.echo(f"migrated {moved} tasks of {job_id} to {dst_pool_id}")


@jobs.command("cmi")
@click.pass_context
def jobs_cmi(click_ctx):
    """Clean up orphaned multi-instance containers on all nodes."""
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    ctx = _ctx(click_ctx)
    count = jobs_mgr.cleanup_mi_containers(ctx.store, ctx.pool.id)
    click.echo(f"cleanup fanned out to {count} nodes")


@jobs.command("profile")
@click.argument("job_id")
@click.option("--steps", type=int, default=10,
              help="Number of train steps to capture with "
                   "torch.profiler")
@click.pass_context
def jobs_profile(click_ctx, job_id, steps):
    """Request an on-demand profile of a job's tasks: the next N
    steps run under torch.profiler and the artifact uploads next
    to the task's diagnostics (see `jobs tasks list`)."""
    fleet.action_jobs_profile(_ctx(click_ctx), job_id, steps=steps)


@jobs.command("preempt")
@click.argument("job_id")
@click.argument("task_id")
@click.option("--reason", default="",
              help="Recorded on the preempt notice (diagnostics)")
@click.pass_context
def jobs_preempt(click_ctx, job_id, task_id, reason):
    """Cooperatively preempt a running task: it drains to its next
    step boundary, forces a COMMITTED checkpoint, and exits with the
    distinct preempted status — requeued at FULL retry budget with
    node health untouched (the preempt sweep's manual override)."""
    fleet.action_jobs_preempt(_ctx(click_ctx), job_id, task_id,
                              reason=reason)


@jobs.command("schedule")
@click.option("--once", is_flag=True, default=False,
              help="Evaluate due schedules once and exit")
@click.option("--poll-interval", type=float, default=5.0)
@click.pass_context
def jobs_schedule(click_ctx, once, poll_interval):
    """Run the recurrence scheduler for jobs with a recurrence block."""
    from batch_shipyard_tpu_torch.jobs import schedules
    ctx = _ctx(click_ctx)
    if once:
        launched = schedules.run_due_schedules(ctx.store, ctx.pool,
                                               ctx.jobs)
        click.echo(f"launched: {launched}")
    else:
        schedules.run_schedule_daemon(ctx.store, ctx.pool, ctx.jobs,
                                      poll_interval=poll_interval)


@jobs.group()
def tasks():
    """Task operations."""


@tasks.command("list")
@click.argument("job_id")
@click.pass_context
def jobs_tasks_list(click_ctx, job_id):
    fleet.action_jobs_tasks_list(_ctx(click_ctx), job_id,
                                 raw=click_ctx.obj["raw"])


@tasks.command("del")
@click.argument("job_id")
@click.argument("task_id")
@click.pass_context
def jobs_tasks_del(click_ctx, job_id, task_id):
    """Delete a terminal task's entity and uploaded files."""
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    ctx = _ctx(click_ctx)
    try:
        jobs_mgr.delete_task(ctx.store, ctx.pool.id, job_id, task_id)
    except (jobs_mgr.JobNotFoundError, ValueError) as exc:
        raise click.ClickException(str(exc))


@tasks.command("count")
@click.argument("job_id")
@click.pass_context
def tasks_count(click_ctx, job_id):
    """Task counts by state for a job (reference `jobs tasks
    count`)."""
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    ctx = _ctx(click_ctx)
    try:
        stats = jobs_mgr.job_stats(ctx.store, ctx.pool.id, job_id)
    except jobs_mgr.JobNotFoundError:
        raise click.ClickException(f"job {job_id} does not exist")
    fleet._emit({"job_id": job_id, "total": stats["tasks"],
                 "by_state": stats["by_state"]},
                click_ctx.obj["raw"])


@tasks.command("term")
@click.argument("job_id")
@click.argument("task_id")
@click.option("--wait", is_flag=True, default=False)
@click.pass_context
def jobs_tasks_term(click_ctx, job_id, task_id, wait):
    """Terminate a single task (kills its process on the node)."""
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    ctx = _ctx(click_ctx)
    jobs_mgr.terminate_task(ctx.store, ctx.pool.id, job_id, task_id,
                            wait=wait)


# ------------------------------ goodput --------------------------------

@cli.group()
def goodput():
    """ML productivity goodput accounting (arxiv 2502.06982): badput
    waterfall + availability x resource x program decomposition over
    the fleet-wide event log."""


@goodput.command("job")
@click.argument("job_id")
@click.option("--trace", "trace_id", default=None,
              help="Scope the waterfall to one submission's trace id "
                   "(see `jobs tasks list` / `trace show`)")
@click.pass_context
def goodput_job(click_ctx, job_id, trace_id):
    """One job's decomposition (queue/image-pull/compile/checkpoint/
    rework badput vs productive step time)."""
    fleet.action_goodput(_ctx(click_ctx), "job", job_id=job_id,
                         raw=click_ctx.obj["raw"],
                         trace_id=trace_id)


@goodput.command("pool")
@click.pass_context
def goodput_pool(click_ctx):
    """Pool rollup (node lifecycle included) + per-job subreports."""
    fleet.action_goodput(_ctx(click_ctx), "pool",
                         raw=click_ctx.obj["raw"])


@goodput.command("fleet")
@click.pass_context
def goodput_fleet(click_ctx):
    """Fleet rollup over every registered pool."""
    fleet.action_goodput(_ctx(click_ctx), "fleet",
                         raw=click_ctx.obj["raw"])


@goodput.command("prune")
@click.option("--older-than-hours", type=float, default=7 * 24.0,
              help="Delete events that ended more than this many "
                   "hours ago (default: one week)")
@click.pass_context
def goodput_prune(click_ctx, older_than_hours):
    """Retention sweep over the pool's event log (the log is
    append-only; accounting scans grow with fleet age)."""
    from batch_shipyard_tpu_torch.goodput import events as goodput_events
    ctx = _ctx(click_ctx)
    removed = goodput_events.prune(ctx.store, ctx.pool.id,
                                   older_than_hours * 3600.0)
    click.echo(f"pruned {removed} events from pool {ctx.pool.id}")


# ------------------------------- trace ---------------------------------

@cli.group()
def trace():
    """End-to-end distributed tracing (trace/): the causal chain of
    one `jobs add` submission — queue wait, claim, backoff,
    rendezvous, program phases, serving requests — assembled from
    TABLE_TRACE spans + trace-tagged goodput intervals."""


@trace.command("show")
@click.argument("trace_id")
@click.pass_context
def trace_show(click_ctx, trace_id):
    """Terminal span waterfall for one trace id."""
    fleet.action_trace_show(_ctx(click_ctx), trace_id,
                            raw=click_ctx.obj["raw"])


@trace.command("export")
@click.argument("trace_id")
@click.option("--output", "-o", default=None,
              help="Write the Chrome trace JSON here (default: "
                   "stdout); load it in chrome://tracing or "
                   "ui.perfetto.dev")
@click.pass_context
def trace_export(click_ctx, trace_id, output):
    """Export one trace as Perfetto-loadable Chrome trace-event
    JSON."""
    fleet.action_trace_export(_ctx(click_ctx), trace_id,
                              output=output)


@trace.command("prune")
@click.option("--older-than-hours", type=float, default=7 * 24.0,
              help="Delete spans that ended more than this many "
                   "hours ago (default: one week)")
@click.pass_context
def trace_prune(click_ctx, older_than_hours):
    """Retention sweep over the pool's span log (same rule as
    `goodput prune`)."""
    from batch_shipyard_tpu_torch.trace import spans as trace_spans_mod
    ctx = _ctx(click_ctx)
    removed = trace_spans_mod.prune(ctx.store, ctx.pool.id,
                                    older_than_hours * 3600.0)
    click.echo(f"pruned {removed} spans from pool {ctx.pool.id}")


# ------------------------------- data ----------------------------------

@cli.group()
def data():
    """Data movement and task file access."""


@data.command("stream")
@click.argument("job_id")
@click.argument("task_id")
@click.option("--filename", default="stdout.txt")
@click.pass_context
def data_stream(click_ctx, job_id, task_id, filename):
    fleet.action_data_stream(_ctx(click_ctx), job_id, task_id, filename)


@data.group("files")
def data_files():
    """Task file access."""


@data_files.command("list")
@click.argument("job_id")
@click.argument("task_id")
@click.pass_context
def data_files_list(click_ctx, job_id, task_id):
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    ctx = _ctx(click_ctx)
    for name in jobs_mgr.list_task_files(ctx.store, ctx.pool.id,
                                         job_id, task_id):
        click.echo(name)


@data_files.command("get")
@click.argument("job_id")
@click.argument("task_id")
@click.option("--dest", default=".")
@click.pass_context
def data_files_get(click_ctx, job_id, task_id, dest):
    """Download all of a task's uploaded files."""
    from batch_shipyard_tpu_torch.data import movement
    from batch_shipyard_tpu_torch.state import names as names_mod
    ctx = _ctx(click_ctx)
    prefix = names_mod.task_output_key(ctx.pool.id, job_id, task_id,
                                       "")
    count = movement.egress_from_storage(ctx.store,
                                         prefix.rstrip("/"), dest)
    click.echo(f"downloaded {count} files to {dest}")


@data.command("ingress")
@click.option("--ssh-private-key", default=None,
              help="Key for direct-to-node (shared fs) ingress")
@click.pass_context
def data_ingress(click_ctx, ssh_private_key):
    from batch_shipyard_tpu_torch.data import movement
    from batch_shipyard_tpu_torch.state import names as names_mod
    ctx = _ctx(click_ctx)
    node_logins = None
    ssh_username = "shipyard"
    if "pool" in ctx.configs:
        from batch_shipyard_tpu_torch.pool import manager as pool_mgr
        node_logins = []
        for row in ctx.store.query_entities(
                names_mod.TABLE_NODES, partition_key=ctx.pool.id):
            if row.get("state") not in pool_mgr.READY_STATES:
                continue  # never shard onto booting/failed nodes
            ip = row.get("external_ip") or row.get("internal_ip")
            if ip:
                node_logins.append((row["_rk"], ip, 22))
        ssh_username = ctx.pool.ssh.username
    movement.ingress_data(ctx.store, ctx.global_settings,
                          pool_id=ctx.pool.id if "pool" in
                          ctx.configs else None,
                          node_logins=node_logins or None,
                          ssh_username=ssh_username,
                          ssh_private_key=ssh_private_key)


# ------------------------------- diag ----------------------------------

@cli.group()
def diag():
    """Diagnostics."""


@diag.command("perf")
@click.pass_context
def diag_perf(click_ctx):
    fleet.action_perf_events(_ctx(click_ctx), raw=click_ctx.obj["raw"])


@diag.group("logs")
def diag_logs():
    """Node log management."""


@diag_logs.command("upload")
@click.pass_context
def diag_logs_upload(click_ctx):
    """Ask every node to ship its logs to the object store."""
    count = fleet.action_diag_logs_upload(_ctx(click_ctx))
    click.echo(f"log upload requested on {count} nodes")


@diag.command("gantt")
@click.option("--output", default=None,
              help="PNG output path (requires matplotlib)")
@click.pass_context
def diag_gantt(click_ctx, output):
    """Render the pool's perf-event timeline."""
    from batch_shipyard_tpu_torch.graph import perf_graph
    ctx = _ctx(click_ctx)
    click.echo(perf_graph.graph_data(ctx.store, ctx.pool.id, output))


# ------------------------------ account --------------------------------

@cli.group()
def account():
    """Account / environment information."""


@account.command("info")
@click.pass_context
def account_info(click_ctx):
    fleet.action_account_info(_ctx(click_ctx),
                              raw=click_ctx.obj["raw"])


@account.command("quota")
@click.option("--zone", default=None,
              help="Zone to inspect (default: credentials gcp.zone)")
@click.pass_context
def account_quota(click_ctx, zone):
    """GPU capacity/quota for a zone: the GPU types it offers and the
    region's GPU quotas (reference `account quota`, its cli/main.py;
    the same --raw keys)."""
    from batch_shipyard_tpu_torch.substrate import quota as quota_mod
    ctx = _ctx(click_ctx)
    if ctx.credentials.gcp is None:
        raise click.ClickException(
            "account quota requires credentials.gcp")
    zone = zone or ctx.credentials.gcp.zone
    if not zone:
        raise click.ClickException(
            "no zone: pass --zone or set credentials gcp.zone")
    client = quota_mod.GpuQuotaClient(ctx.credentials.gcp.project)
    fleet._emit(quota_mod.quota_report(client, zone),
                click_ctx.obj["raw"])


# ------------------------------ secrets --------------------------------

def _secret_io_params(click_ctx):
    return _ctx(click_ctx).secret_io


@cli.group()
def secrets():
    """Secret store management (the keyvault group analog)."""


@secrets.command("put")
@click.argument("secret_id")
@click.option("--value", default=None,
              help="Secret value; read from stdin when omitted so it "
                   "stays out of shell history")
@click.pass_context
def secrets_put(click_ctx, secret_id, value):
    """Store a value under a secret:// id (keyvault add analog)."""
    import sys as _sys

    from batch_shipyard_tpu_torch.utils import secrets as secrets_mod
    if value is None:
        value = _sys.stdin.read().rstrip("\n")
    secrets_file, project = _secret_io_params(click_ctx)
    secrets_mod.store_secret(secret_id, value,
                             secrets_file=secrets_file,
                             project=project)
    click.echo(f"stored {secret_id}")


@secrets.command("get")
@click.argument("secret_id")
@click.pass_context
def secrets_get(click_ctx, secret_id):
    """Resolve and print a secret:// id."""
    from batch_shipyard_tpu_torch.utils import secrets as secrets_mod
    secrets_file, project = _secret_io_params(click_ctx)
    click.echo(secrets_mod.resolve_secret(
        secret_id, secrets_file=secrets_file, project=project))


@secrets.command("store-credentials")
@click.argument("secret_id")
@click.pass_context
def secrets_store_credentials(click_ctx, secret_id):
    """Store the loaded credentials.yaml under one secret id (the
    reference keeps whole credential files in KeyVault)."""
    from batch_shipyard_tpu_torch.utils import secrets as secrets_mod
    ctx = _ctx(click_ctx)
    raw = ctx.configs.get("credentials")
    if not raw:
        raise click.ClickException("no credentials config loaded")
    secrets_file, project = _secret_io_params(click_ctx)
    secrets_mod.store_credentials_config(
        secret_id, raw, secrets_file=secrets_file, project=project)
    click.echo(f"credentials stored at {secret_id}")


@secrets.command("fetch-credentials")
@click.argument("secret_id")
@click.option("--out", default=None,
              help="Write to this file instead of stdout")
@click.pass_context
def secrets_fetch_credentials(click_ctx, secret_id, out):
    """Fetch a credentials.yaml stored via store-credentials."""
    import yaml as _yaml

    from batch_shipyard_tpu_torch.utils import secrets as secrets_mod
    secrets_file, project = _secret_io_params(click_ctx)
    data = secrets_mod.fetch_credentials_config(
        secret_id, secrets_file=secrets_file, project=project)
    text = _yaml.safe_dump(data, default_flow_style=False)
    if out:
        import os as _os

        # Credential material: never world-readable (matches
        # store_secret's 0o600 on the secrets file).
        with open(out, "w", encoding="utf-8",
                  opener=lambda p, f: _os.open(p, f, 0o600)) as fh:
            fh.write(text)
        click.echo(f"wrote {out}")
    else:
        click.echo(text)


# ------------------------------ storage --------------------------------

@cli.group()
def storage():
    """State store management."""


@storage.command("sas")
@click.argument("key")
@click.option("--method", default="GET",
              type=click.Choice(["GET", "PUT", "DELETE"]))
@click.option("--expires-seconds", type=float, default=3600.0)
@click.option("--prefix", "as_prefix", is_flag=True,
              help="Treat KEY as a prefix: sign every object under "
                   "it (GET only)")
@click.pass_context
def storage_sas(click_ctx, key, method, expires_seconds, as_prefix):
    """Mint time-limited signed URL(s) for an object or prefix —
    hand a task output or ingress prefix to a third party without
    sharing credentials (reference `storage sas create`,
    shipyard.py:1327; GCS V4 signed URLs here)."""
    ctx = _ctx(click_ctx)
    if as_prefix:
        if method != "GET":
            raise click.ClickException(
                "--prefix signing is GET-only (a PUT prefix would "
                "grant arbitrary-name writes)")
        keys = ctx.store.list_objects(prefix=key)
        if not keys:
            raise click.ClickException(
                f"no objects under prefix {key!r}")
    else:
        keys = [key]
    try:
        urls = {k: ctx.store.generate_signed_url(
            k, method=method, expires_seconds=expires_seconds)
            for k in keys}
    except NotImplementedError as exc:
        raise click.ClickException(str(exc))
    fleet._emit({"method": method,
                 "expires_seconds": expires_seconds,
                 "urls": urls}, click_ctx.obj["raw"])


@storage.command("clear")
@click.option("-y", "--yes", is_flag=True, default=False)
@click.pass_context
def storage_clear(click_ctx, yes):
    """Clear ALL framework state (containers/tables/queues analog)."""
    ctx = _ctx(click_ctx)
    if not yes and not click.confirm(
            "Clear ALL state in the configured store?"):
        raise click.Abort()
    ctx.store.clear()


def main():
    return cli(prog_name="shipyard-tpu-torch")


if __name__ == "__main__":
    sys.exit(main())
