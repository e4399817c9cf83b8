"""Typed settings: the single choke-point between raw YAML dicts and code.

The port's copy of batch_shipyard_tpu/config/settings.py: the same
dataclasses over the same YAML keys, so a pool or jobs file either
package reads, the other reads alike. What differs is the pool's
accelerator. In place of the ``tpu:`` block and its slice oracle, a pool
is a GPU pool when ``vm_configuration.vm_size`` names a GPU machine type
(parallel/topology.py: GCE's A3 types, 1-8 H100s a node); its nodes form
one flat set. A pool spec with a ``tpu:`` block is refused.

No module outside config/ should ever index into the raw config dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from batch_shipyard_tpu_torch.parallel import topology as topo


def _get(conf: dict | None, *path: str, default: Any = None) -> Any:
    node: Any = conf
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return default
        node = node[key]
    if node is None:
        return default
    return node


# -------------------------- credentials --------------------------------

@dataclasses.dataclass(frozen=True)
class GcpCredentialsSettings:
    project: str
    zone: Optional[str]
    service_account_key_file: Optional[str]
    service_account_email: Optional[str]


@dataclasses.dataclass(frozen=True)
class StorageCredentialsSettings:
    backend: str  # gcs | localfs | memory
    bucket: Optional[str]
    prefix: str
    root: Optional[str]


@dataclasses.dataclass(frozen=True)
class SshCredentialsSettings:
    username: Optional[str]
    private_key_file: Optional[str]
    public_key_file: Optional[str]


@dataclasses.dataclass(frozen=True)
class DockerRegistrySettings:
    server: str
    username: Optional[str]
    password: Optional[str]
    password_secret_id: Optional[str]


@dataclasses.dataclass(frozen=True)
class CredentialsSettings:
    gcp: Optional[GcpCredentialsSettings]
    storage: StorageCredentialsSettings
    ssh: SshCredentialsSettings
    docker_registries: tuple[DockerRegistrySettings, ...]


def credentials_settings(config: dict) -> CredentialsSettings:
    creds = _get(config, "credentials", default={})
    gcp = None
    if _get(creds, "gcp") is not None:
        gcp = GcpCredentialsSettings(
            project=_get(creds, "gcp", "project"),
            zone=_get(creds, "gcp", "zone"),
            service_account_key_file=_get(
                creds, "gcp", "service_account_key_file"),
            service_account_email=_get(creds, "gcp", "service_account_email"),
        )
    storage = StorageCredentialsSettings(
        backend=_get(creds, "storage", "backend", default="memory"),
        bucket=_get(creds, "storage", "bucket"),
        prefix=_get(creds, "storage", "prefix", default="shipyardtpu"),
        root=_get(creds, "storage", "root"),
    )
    ssh = SshCredentialsSettings(
        username=_get(creds, "ssh", "username"),
        private_key_file=_get(creds, "ssh", "private_key_file"),
        public_key_file=_get(creds, "ssh", "public_key_file"),
    )
    registries = tuple(
        DockerRegistrySettings(
            server=reg["server"],
            username=reg.get("username"),
            password=reg.get("password"),
            password_secret_id=reg.get("password_secret_id"),
        )
        for reg in _get(creds, "docker_registries", default=[])
    )
    return CredentialsSettings(
        gcp=gcp, storage=storage, ssh=ssh, docker_registries=registries)


# ---------------------------- global -----------------------------------

@dataclasses.dataclass(frozen=True)
class GlobalSettings:
    storage_entity_prefix: str
    fallback_registry: Optional[str]
    raw_output: bool
    docker_images: tuple[str, ...]
    singularity_images: tuple[str, ...]
    files: tuple[dict, ...]
    concurrent_source_downloads: int
    docker_registries: tuple["DockerRegistry", ...] = ()


@dataclasses.dataclass(frozen=True)
class DockerRegistry:
    """Private registry credentials (reference analog:
    convoy/settings.py docker_registry accessors +
    scripts/registry_login.sh — nodes log in before cascade pulls).
    ``password`` should be a secret:// ref (utils/secrets.py), which
    is stored verbatim and resolved ON NODE at login time — plaintext
    never lands in the state store. ``auth='gcloud'`` instead runs
    ``gcloud auth configure-docker <server>`` (Artifact Registry)."""
    server: str
    username: Optional[str] = None
    password: Optional[str] = None
    auth: str = "basic"           # basic | gcloud


def global_settings(config: dict) -> GlobalSettings:
    registries = []
    for entry in _get(config, "shipyard_tpu", "docker_registries",
                      default=[]) or []:
        registries.append(DockerRegistry(
            server=entry["server"],
            username=entry.get("username"),
            password=entry.get("password"),
            auth=entry.get("auth", "basic")))
    return GlobalSettings(
        storage_entity_prefix=_get(
            config, "shipyard_tpu", "storage_entity_prefix",
            default="shipyardtpu"),
        fallback_registry=_get(config, "shipyard_tpu", "fallback_registry"),
        raw_output=_get(config, "shipyard_tpu", "raw_output", default=False),
        docker_images=tuple(
            _get(config, "global_resources", "docker_images", default=[])),
        singularity_images=tuple(
            _get(config, "global_resources", "singularity_images",
                 default=[])),
        files=tuple(
            _get(config, "global_resources", "files", default=[])),
        concurrent_source_downloads=_get(
            config, "data_replication", "concurrent_source_downloads",
            default=10),
        docker_registries=tuple(registries),
    )


# ----------------------------- pool ------------------------------------

@dataclasses.dataclass(frozen=True)
class AutoscaleScenarioSettings:
    name: str
    maximum_vm_count_dedicated: int
    maximum_vm_count_low_priority: int
    minimum_vm_count_dedicated: int
    minimum_vm_count_low_priority: int
    maximum_vm_increment_dedicated: int
    maximum_vm_increment_low_priority: int
    node_deallocation_option: str
    sample_lookback_interval_minutes: int
    required_sample_percentage: int
    bias_last_sample: bool
    bias_node_type: str
    rebalance_preemption_percentage: Optional[int]
    time_ranges: dict


@dataclasses.dataclass(frozen=True)
class AutoscaleSettings:
    enabled: bool
    evaluation_interval_seconds: int
    scenario: Optional[AutoscaleScenarioSettings]
    formula: Optional[str]


@dataclasses.dataclass(frozen=True)
class PoolSshSettings:
    username: str
    expiry_days: int
    generate_keypair: bool


@dataclasses.dataclass(frozen=True)
class PrometheusExporterSettings:
    enabled: bool
    port: int


@dataclasses.dataclass(frozen=True)
class PoolServicesSettings:
    """Pool-resident daemons hosted by worker 0's node agent (the
    reference runs its recurrent job manager as a job-manager task on
    the pool, cargo/recurrent_job_manager.py:187 — a recurrence keeps
    firing with no operator terminal alive)."""
    schedules: bool
    autoscale: bool
    poll_interval_seconds: float


@dataclasses.dataclass(frozen=True)
class SchedPolicySettings:
    """Pool-level scheduling-policy configuration. The knob fields
    mirror sched/policy.py ``PolicyKnobs`` ONE-TO-ONE by name
    (enforced by tests/test_names_consistency.py); None falls back to
    the PolicyKnobs default — ``sched.policy.knobs_from_settings``
    derives the knob set every consumer (agent claim path, preemption
    sweep, autoscale, fleet simulator) prices decisions with."""
    # Opt-in for warm-cache affinity deferral at claim time (the
    # claim itself is never blocked past the affinity window).
    claim_scoring: bool
    warm_cache_bonus_seconds: Optional[float]
    health_debit_seconds: Optional[float]
    backoff_debit_seconds: Optional[float]
    claim_affinity_wait_seconds: Optional[float]
    victim_warm_cost_seconds: Optional[float]
    victim_step_cost_weight: Optional[float]
    provision_seconds_per_node: Optional[float]
    avg_task_seconds: Optional[float]
    queue_tolerance_seconds: Optional[float]


@dataclasses.dataclass(frozen=True)
class SloClassSettings:
    """One serving SLO class: per-request latency targets attached at
    admission (models/serving.Request). None disables that target
    (best-effort on that axis)."""
    name: str
    ttft_ms: Optional[float]
    tpot_ms: Optional[float]


@dataclasses.dataclass(frozen=True)
class ServingSloSettings:
    """Request-level SLO scheduling configuration for the serving
    front end (models/server.py): named classes map to TTFT/TPOT
    targets, shed_grace_ms arms overload shedding in the engine, and
    tpot_stall_factor bounds admission's prefill-stall tolerance
    (models/serving.ContinuousBatcher)."""
    classes: tuple[SloClassSettings, ...]
    shed_grace_ms: Optional[float]
    tpot_stall_factor: float

    def class_targets(self) -> dict:
        """name -> {"ttft_ms": ..., "tpot_ms": ...} for the front
        end's slo_classes parameter."""
        return {c.name: {"ttft_ms": c.ttft_ms, "tpot_ms": c.tpot_ms}
                for c in self.classes}


# Default classes: interactive chat, standard API traffic, and
# untargeted batch/offline work (the class FIFO falls back to).
DEFAULT_SLO_CLASSES = (
    SloClassSettings("interactive", ttft_ms=500.0, tpot_ms=100.0),
    SloClassSettings("standard", ttft_ms=2000.0, tpot_ms=250.0),
    SloClassSettings("batch", ttft_ms=None, tpot_ms=None),
)


def serving_slo_settings(config: dict | None) -> ServingSloSettings:
    """Parse serving.slo from a config mapping; absent sections fall
    back to the default class table with shedding disarmed."""
    spec = _get(config, "serving", "slo", default={}) or {}
    entries = _get(spec, "classes")
    if entries is None:
        classes = DEFAULT_SLO_CLASSES
    else:
        classes = tuple(
            SloClassSettings(
                name=_get(entry, "name"),
                ttft_ms=_get(entry, "ttft_ms"),
                tpot_ms=_get(entry, "tpot_ms"))
            for entry in entries)
    return ServingSloSettings(
        classes=classes,
        shed_grace_ms=_get(spec, "shed_grace_ms"),
        tpot_stall_factor=_get(spec, "tpot_stall_factor",
                               default=4.0),
    )


@dataclasses.dataclass(frozen=True)
class PoolSettings:
    id: str
    substrate: str  # tpu_vm (the cloud VM substrate) | fake | localhost
    # GCP zone override for this pool (falls back to credentials
    # gcp.zone). Federation's `location` hard constraint matches
    # against it (reference PoolConstraints.location,
    # federation/federation.py:190).
    zone: Optional[str]
    vm_size: Optional[str]
    # The H100s one node holds, from vm_size (parallel/topology.py); 0
    # for a size without GPUs.
    gpus_per_node: int
    vm_count_dedicated: int
    vm_count_low_priority: int
    task_slots_per_node: int
    inter_node_communication_enabled: bool
    container_runtimes: tuple[str, ...]
    # Docker's default runtime for task containers: 'runc' or
    # 'kata_containers' (VM-isolated containers via kata-runtime —
    # reference container_runtimes.default, schemas/pool.yaml:383 +
    # shipyard_nodeprep.sh:1105/1133).
    container_runtime_default: str
    additional_node_prep_commands: tuple[str, ...]
    reboot_on_start_task_failed: bool
    attempt_recovery_on_unusable: bool
    block_until_all_global_resources_loaded: bool
    autoscale: AutoscaleSettings
    ssh: PoolSshSettings
    environment_variables: dict
    max_wait_time_seconds: int
    # None = upload task outputs in full (streamed); a value caps each
    # output at head+tail around an explicit truncation marker.
    output_upload_cap_mb: Optional[int]
    # Task queue fan-out: >1 spreads task messages over N queues so
    # large pools (10^4+ tasks) don't serialize on one queue's lock.
    task_queue_shards: int
    node_exporter: PrometheusExporterSettings
    cadvisor: PrometheusExporterSettings
    pool_services: "PoolServicesSettings" = None  # set by parser
    sched_policy: Optional["SchedPolicySettings"] = None
    # The cloud substrate's boot image (vm_configuration.image: an
    # image name, or a projects/P/global/images[/family]/N path) and
    # the pre-existing network and subnet its VMs join
    # (virtual_network: name, subnet_name).
    image: Optional[str] = None
    network: Optional[str] = None
    subnetwork: Optional[str] = None

    @property
    def is_gpu_pool(self) -> bool:
        """The reference's is_gpu_pool (convoy settings.py:717): the
        pool's vm_size names a GPU machine type."""
        return self.gpus_per_node > 0

    @property
    def is_gang_capable(self) -> bool:
        """Multi-instance tasks require inter-node communication
        (reference batch.py:4616): a GPU pool's nodes are separate
        hosts, so the pool must say so."""
        return self.inter_node_communication_enabled

    @property
    def current_node_count(self) -> int:
        return self.vm_count_dedicated + self.vm_count_low_priority


def pool_settings(config: dict) -> PoolSettings:
    spec = _get(config, "pool_specification", default=None)
    if spec is None:
        raise ValueError("pool_specification is missing from pool config")
    if _get(spec, "tpu") is not None:
        raise ValueError(
            f"pool {spec.get('id')!r}: pool_specification.tpu is a TPU "
            "pool, which this package does not run; name a GPU machine "
            "type in vm_configuration.vm_size (one of "
            f"{', '.join(topo.machine_types())}) instead")
    vm_size = _get(spec, "vm_configuration", "vm_size")
    scenario = None
    if _get(spec, "autoscale", "scenario") is not None:
        sc = _get(spec, "autoscale", "scenario")
        scenario = AutoscaleScenarioSettings(
            name=_get(sc, "name", default="active_tasks"),
            maximum_vm_count_dedicated=_get(
                sc, "maximum_vm_count", "dedicated", default=16),
            maximum_vm_count_low_priority=_get(
                sc, "maximum_vm_count", "low_priority", default=0),
            minimum_vm_count_dedicated=_get(
                sc, "minimum_vm_count", "dedicated", default=0),
            minimum_vm_count_low_priority=_get(
                sc, "minimum_vm_count", "low_priority", default=0),
            maximum_vm_increment_dedicated=_get(
                sc, "maximum_vm_increment_per_evaluation", "dedicated",
                default=0),
            maximum_vm_increment_low_priority=_get(
                sc, "maximum_vm_increment_per_evaluation", "low_priority",
                default=0),
            node_deallocation_option=_get(
                sc, "node_deallocation_option", default="taskcompletion"),
            sample_lookback_interval_minutes=_get(
                sc, "sample_lookback_interval_minutes", default=10),
            required_sample_percentage=_get(
                sc, "required_sample_percentage", default=70),
            bias_last_sample=_get(sc, "bias_last_sample", default=True),
            bias_node_type=_get(sc, "bias_node_type", default="auto"),
            rebalance_preemption_percentage=_get(
                sc, "rebalance_preemption_percentage"),
            time_ranges=_get(sc, "time_ranges", default={}),
        )
    autoscale = AutoscaleSettings(
        enabled=_get(spec, "autoscale", "enabled", default=False),
        evaluation_interval_seconds=_get(
            spec, "autoscale", "evaluation_interval_seconds", default=900),
        scenario=scenario,
        formula=_get(spec, "autoscale", "formula"),
    )
    sched_policy = None
    if _get(spec, "sched_policy") is not None:
        sp = _get(spec, "sched_policy")
        sched_policy = SchedPolicySettings(
            claim_scoring=_get(sp, "claim_scoring", default=False),
            warm_cache_bonus_seconds=_get(
                sp, "warm_cache_bonus_seconds"),
            health_debit_seconds=_get(sp, "health_debit_seconds"),
            backoff_debit_seconds=_get(sp, "backoff_debit_seconds"),
            claim_affinity_wait_seconds=_get(
                sp, "claim_affinity_wait_seconds"),
            victim_warm_cost_seconds=_get(
                sp, "victim_warm_cost_seconds"),
            victim_step_cost_weight=_get(
                sp, "victim_step_cost_weight"),
            provision_seconds_per_node=_get(
                sp, "provision_seconds_per_node"),
            avg_task_seconds=_get(sp, "avg_task_seconds"),
            queue_tolerance_seconds=_get(
                sp, "queue_tolerance_seconds"),
        )
    return PoolSettings(
        id=spec["id"],
        substrate=_get(spec, "substrate", default="tpu_vm"),
        zone=_get(spec, "zone"),
        vm_size=vm_size,
        gpus_per_node=topo.gpus_per_node(vm_size),
        vm_count_dedicated=_get(
            spec, "vm_configuration", "vm_count", "dedicated", default=0),
        vm_count_low_priority=_get(
            spec, "vm_configuration", "vm_count", "low_priority", default=0),
        task_slots_per_node=_get(spec, "task_slots_per_node", default=1),
        inter_node_communication_enabled=_get(
            spec, "inter_node_communication_enabled", default=False),
        container_runtimes=tuple(
            _get(spec, "container_runtimes", default=["docker"])),
        container_runtime_default=_get(
            spec, "container_runtime_default", default="runc"),
        additional_node_prep_commands=tuple(
            _get(spec, "node_prep", "additional_commands", default=[])),
        reboot_on_start_task_failed=_get(
            spec, "node_prep", "reboot_on_start_task_failed", default=False),
        attempt_recovery_on_unusable=_get(
            spec, "node_prep", "attempt_recovery_on_unusable", default=False),
        block_until_all_global_resources_loaded=_get(
            spec, "node_prep", "block_until_all_global_resources_loaded",
            default=True),
        autoscale=autoscale,
        ssh=PoolSshSettings(
            username=_get(spec, "ssh", "username", default="shipyard"),
            expiry_days=_get(spec, "ssh", "expiry_days", default=30),
            generate_keypair=_get(
                spec, "ssh", "generate_keypair", default=True),
        ),
        environment_variables=_get(
            spec, "environment_variables", default={}),
        max_wait_time_seconds=_get(
            spec, "max_wait_time_seconds", default=1800),
        output_upload_cap_mb=_get(
            spec, "output_upload_cap_mb", default=None),
        task_queue_shards=_get(
            spec, "task_queue_shards", default=1),
        node_exporter=PrometheusExporterSettings(
            enabled=_get(
                spec, "prometheus", "node_exporter", "enabled",
                default=False),
            port=_get(
                spec, "prometheus", "node_exporter", "port", default=9100),
        ),
        cadvisor=PrometheusExporterSettings(
            enabled=_get(
                spec, "prometheus", "cadvisor", "enabled", default=False),
            port=_get(spec, "prometheus", "cadvisor", "port", default=8080),
        ),
        pool_services=PoolServicesSettings(
            schedules=_get(
                spec, "pool_services", "schedules", default=False),
            autoscale=_get(
                spec, "pool_services", "autoscale", default=False),
            poll_interval_seconds=_get(
                spec, "pool_services", "poll_interval_seconds",
                default=5.0),
        ),
        sched_policy=sched_policy,
        image=_get(spec, "vm_configuration", "image"),
        network=_get(spec, "virtual_network", "name"),
        subnetwork=_get(spec, "virtual_network", "subnet_name"),
    )


# ----------------------------- jobs ------------------------------------

@dataclasses.dataclass(frozen=True)
class RecurrenceSettings:
    recurrence_interval_seconds: int
    do_not_run_until: Optional[str]
    do_not_run_after: Optional[str]
    start_window_seconds: Optional[int]
    monitor_task_completion: bool
    run_exclusive: bool


@dataclasses.dataclass(frozen=True)
class JaxDistributedSettings:
    enabled: bool
    coordinator_port: int
    transport: str  # ici | dcn | auto
    heartbeat_timeout_seconds: int


@dataclasses.dataclass(frozen=True)
class MultiInstanceSettings:
    num_instances: Any  # int | 'pool_current_dedicated' | 'pool_specification_vm_count'
    coordination_command: Optional[str]
    resource_files: tuple[dict, ...]
    jax_distributed: JaxDistributedSettings
    pytorch_xla: bool
    # Elastic gang floor: a gang that loses nodes may re-form at any
    # surviving size >= min_instances (resumed state is re-sharded
    # onto the smaller mesh by parallel/sharding.reshard_on_restore).
    # None = rigid gang (the historical contract): all-or-nothing.
    min_instances: Optional[int] = None

    def resolve_num_instances(self, pool: PoolSettings) -> int:
        if isinstance(self.num_instances, int):
            return self.num_instances
        if self.num_instances in (
                "pool_current_dedicated", "pool_specification_vm_count",
                "pool_current_low_priority"):
            return pool.current_node_count
        raise ValueError(
            f"cannot resolve num_instances {self.num_instances!r}")


@dataclasses.dataclass(frozen=True)
class TaskSettings:
    id: Optional[str]
    docker_image: Optional[str]
    singularity_image: Optional[str]
    runtime: str  # docker | singularity | none
    command: str
    environment_variables: dict
    tpu: bool
    gpus: int
    depends_on: tuple[str, ...]
    depends_on_range: Optional[tuple[int, int]]
    max_task_retries: int
    max_wall_time_seconds: Optional[int]
    # Numeric scheduling priority WITHIN the job's queue band: the
    # preempt sweep compares these to elect victims (higher pending
    # beats lower running). Defaults to the job's priority.
    priority: int
    # Wedge watchdog opt-in: kill + requeue the task when it emits no
    # progress beat ($SHIPYARD_PROGRESS_FILE) for this long.
    progress_deadline_seconds: Optional[int]
    # Compile-cache identity digest (compilecache/manager.py
    # identity_key) this task's program compiles under. Advisory
    # placement hint: the claim path's warm-cache affinity policy
    # (sched/policy.py) prefers nodes whose persistent cache already
    # holds this identity; exported as
    # $SHIPYARD_COMPILE_CACHE_IDENTITY for the workload to enable the
    # cache with.
    compile_cache_identity: Optional[str]
    retention_time_seconds: Optional[int]
    multi_instance: Optional[MultiInstanceSettings]
    input_data: tuple[dict, ...]
    output_data: tuple[dict, ...]
    resource_files: tuple[dict, ...]
    remove_container_after_exit: bool
    shm_size: Optional[str]
    additional_docker_run_options: tuple[str, ...]
    additional_singularity_options: tuple[str, ...]
    task_factory: Optional[dict]
    merge_task: bool
    default_exit_options: dict

    @property
    def image(self) -> Optional[str]:
        return self.docker_image or self.singularity_image

    @property
    def is_multi_instance(self) -> bool:
        return self.multi_instance is not None


@dataclasses.dataclass(frozen=True)
class JobSettings:
    id: str
    pool_id: Optional[str]
    auto_complete: bool
    priority: int
    max_task_retries: int
    max_wall_time_seconds: Optional[int]
    allow_run_on_missing_image: bool
    environment_variables: dict
    # secret:// ref whose resolved value is a JSON/YAML map of extra
    # env vars, resolved ON NODE at task launch (the reference's
    # environment_variables_keyvault_secret_id, keyvault.py:176 —
    # whole env blocks ride KeyVault, never the state store).
    environment_variables_secret_id: Optional[str]
    recurrence: Optional[RecurrenceSettings]
    job_preparation_command: Optional[str]
    job_release_command: Optional[str]
    # Per-job scratch space with job lifetime (the reference's BeeOND
    # auto_scratch analog, settings.py:1496/batch.py:4949 — there a
    # distributed FS across job nodes; here node-local NVMe scratch
    # at SHIPYARD_JOB_SCRATCH, created at job prep and removed at job
    # release; cross-node sharing rides gcsfuse/fs clusters instead).
    auto_scratch: bool
    input_data: tuple[dict, ...]
    tasks: tuple[dict, ...]  # raw task dicts (expanded by task factories)
    merge_task: Optional[dict]
    federation_constraints: dict
    # auto_pool: {"keep_alive": bool} — the job provisions its own
    # pool (derived from the configured pool spec) and the reaper
    # tears it down when the job completes (reference
    # _construct_auto_pool_specification, fleet.py:1768).
    auto_pool: Optional[dict]
    # Server-side task-factory expansion: submit the generator spec
    # as ONE expansion row and let the pool's leader-gated expander
    # (jobs/expansion.py) materialize task rows + queue messages —
    # the client round-trips O(1) instead of O(tasks). Requires every
    # task to carry a task_factory (there is no per-task payload to
    # ship otherwise).
    server_side_expansion: bool = False


def job_settings_list(config: dict) -> list[JobSettings]:
    jobs = _get(config, "job_specifications", default=None)
    if jobs is None:
        raise ValueError("job_specifications is missing from jobs config")
    return [_job_settings(j) for j in jobs]


def _job_settings(job: dict) -> JobSettings:
    recurrence = None
    if _get(job, "recurrence") is not None:
        recurrence = RecurrenceSettings(
            recurrence_interval_seconds=_get(
                job, "recurrence", "schedule",
                "recurrence_interval_seconds"),
            do_not_run_until=_get(
                job, "recurrence", "schedule", "do_not_run_until"),
            do_not_run_after=_get(
                job, "recurrence", "schedule", "do_not_run_after"),
            start_window_seconds=_get(
                job, "recurrence", "schedule", "start_window_seconds"),
            monitor_task_completion=_get(
                job, "recurrence", "job_manager", "monitor_task_completion",
                default=False),
            run_exclusive=_get(
                job, "recurrence", "job_manager", "run_exclusive",
                default=False),
        )
    return JobSettings(
        id=job["id"],
        pool_id=_get(job, "pool_id"),
        auto_complete=_get(job, "auto_complete", default=False),
        priority=_get(job, "priority", default=0),
        max_task_retries=_get(job, "max_task_retries", default=0),
        max_wall_time_seconds=_get(job, "max_wall_time_seconds"),
        allow_run_on_missing_image=_get(
            job, "allow_run_on_missing_image", default=False),
        environment_variables=_get(
            job, "environment_variables", default={}),
        environment_variables_secret_id=_get(
            job, "environment_variables_keyvault_secret_id"),
        recurrence=recurrence,
        job_preparation_command=_get(job, "job_preparation", "command"),
        job_release_command=_get(job, "job_release", "command"),
        auto_scratch=_get(job, "auto_scratch", default=False),
        input_data=tuple(_get(job, "input_data", default=[])),
        tasks=tuple(_get(job, "tasks", default=[])),
        merge_task=_get(job, "merge_task"),
        federation_constraints=_get(
            job, "federation_constraints", default={}),
        auto_pool=_get(job, "auto_pool"),
        server_side_expansion=_get(job, "server_side_expansion",
                                   default=False),
    )


def job_settings_to_raw(job: JobSettings) -> dict:
    """Invert ``_job_settings``: a raw job dict that parses back to an
    equal JobSettings. This is what the server-side expansion row
    stores — the expander re-derives the full settings pool-side from
    one JSON-serializable dict, so the wire format stays the config
    schema itself rather than a second pickled shape."""
    raw: dict = {
        "id": job.id,
        "pool_id": job.pool_id,
        "auto_complete": job.auto_complete,
        "priority": job.priority,
        "max_task_retries": job.max_task_retries,
        "max_wall_time_seconds": job.max_wall_time_seconds,
        "allow_run_on_missing_image": job.allow_run_on_missing_image,
        "environment_variables": dict(job.environment_variables),
        "auto_scratch": job.auto_scratch,
        "input_data": [dict(d) for d in job.input_data],
        "tasks": [dict(t) for t in job.tasks],
        "merge_task": job.merge_task,
        "federation_constraints": dict(job.federation_constraints),
        "auto_pool": job.auto_pool,
        "server_side_expansion": job.server_side_expansion,
    }
    if job.environment_variables_secret_id is not None:
        raw["environment_variables_keyvault_secret_id"] = \
            job.environment_variables_secret_id
    if job.job_preparation_command is not None:
        raw["job_preparation"] = {
            "command": job.job_preparation_command}
    if job.job_release_command is not None:
        raw["job_release"] = {"command": job.job_release_command}
    if job.recurrence is not None:
        rec = job.recurrence
        raw["recurrence"] = {
            "schedule": {
                "recurrence_interval_seconds":
                    rec.recurrence_interval_seconds,
                "do_not_run_until": rec.do_not_run_until,
                "do_not_run_after": rec.do_not_run_after,
                "start_window_seconds": rec.start_window_seconds,
            },
            "job_manager": {
                "monitor_task_completion":
                    rec.monitor_task_completion,
                "run_exclusive": rec.run_exclusive,
            },
        }
    return raw


def task_settings(task: dict, job: JobSettings,
                  pool: PoolSettings | None = None) -> TaskSettings:
    """Merge pool/job/task layers into final task settings.

    Reference analog: settings.task_settings (settings.py:3727) which
    merges pool+job+task config, resolves images and run options.
    """
    env = dict(pool.environment_variables) if pool is not None else {}
    env.update(job.environment_variables)
    env.update(_get(task, "environment_variables", default={}))
    runtime = _get(task, "runtime")
    docker_image = _get(task, "docker_image")
    singularity_image = _get(task, "singularity_image")
    if runtime is None:
        if docker_image:
            runtime = "docker"
        elif singularity_image:
            runtime = "singularity"
        else:
            runtime = "none"
    if docker_image and singularity_image:
        raise ValueError(
            "task may not specify both docker_image and singularity_image")
    mi = None
    if _get(task, "multi_instance") is not None:
        raw_mi = _get(task, "multi_instance")
        mi = MultiInstanceSettings(
            num_instances=_get(raw_mi, "num_instances", default=1),
            min_instances=_get(raw_mi, "min_instances"),
            coordination_command=_get(raw_mi, "coordination_command"),
            resource_files=tuple(
                _get(raw_mi, "resource_files", default=[])),
            jax_distributed=JaxDistributedSettings(
                enabled=_get(
                    raw_mi, "jax_distributed", "enabled", default=True),
                coordinator_port=_get(
                    raw_mi, "jax_distributed", "coordinator_port",
                    default=8476),
                transport=_get(
                    raw_mi, "jax_distributed", "transport", default="auto"),
                heartbeat_timeout_seconds=_get(
                    raw_mi, "jax_distributed", "heartbeat_timeout_seconds",
                    default=100),
            ),
            pytorch_xla=_get(raw_mi, "pytorch_xla", "enabled", default=False),
        )
    depends_on_range = None
    if _get(task, "depends_on_range") is not None:
        rng = _get(task, "depends_on_range")
        depends_on_range = (rng[0], rng[1])
    return TaskSettings(
        id=_get(task, "id"),
        docker_image=docker_image,
        singularity_image=singularity_image,
        runtime=runtime,
        command=_get(task, "command", default=""),
        environment_variables=env,
        # The reference's task flag for a TPU pool's chips; the port
        # runs no TPU pool, so it is False unless the YAML says so, and
        # kept so a task row carries the reference's columns.
        tpu=_get(task, "tpu", default=False),
        gpus=_get(task, "gpus", default=0),
        depends_on=tuple(_get(task, "depends_on", default=[])),
        depends_on_range=depends_on_range,
        max_task_retries=_get(
            task, "max_task_retries", default=job.max_task_retries),
        max_wall_time_seconds=_get(
            task, "max_wall_time_seconds", default=job.max_wall_time_seconds),
        priority=_get(task, "priority", default=job.priority),
        progress_deadline_seconds=_get(task,
                                       "progress_deadline_seconds"),
        compile_cache_identity=_get(task, "compile_cache_identity"),
        retention_time_seconds=_get(task, "retention_time_seconds"),
        multi_instance=mi,
        input_data=tuple(_get(task, "input_data", default=[])),
        output_data=tuple(_get(task, "output_data", default=[])),
        resource_files=tuple(_get(task, "resource_files", default=[])),
        remove_container_after_exit=_get(
            task, "remove_container_after_exit", default=True),
        shm_size=_get(task, "shm_size"),
        additional_docker_run_options=tuple(
            _get(task, "additional_docker_run_options", default=[])),
        additional_singularity_options=tuple(
            _get(task, "additional_singularity_options", default=[])),
        task_factory=_get(task, "task_factory"),
        merge_task=_get(task, "merge_task", default=False),
        default_exit_options=_get(
            task, "exit_conditions", "default", "exit_options", default={}),
    )
