"""The port's strict config validation (batch_shipyard_tpu_torch.config.
validator and its own eight schemas) against the reference's: every case
of tests/test_validator.py through both validators with equal error
lists, every shipped recipe config with equal error lists, the schemas
equal key for key, and a ``tpu:`` pool the schema accepts and the port's
settings refuse."""

import pathlib

import pytest
import yaml

from batch_shipyard_tpu.config import validator as ref
from batch_shipyard_tpu_torch.config import settings
from batch_shipyard_tpu_torch.config import validator as port

REPO = pathlib.Path(__file__).resolve().parent.parent
RECIPES = REPO / "recipes"


def _errors(module, data, schema):
    return module.validate(data, schema)


def _both(data, schema):
    """The port's error list, after checking the reference's is equal."""
    got = _errors(port, data, schema)
    assert got == _errors(ref, data, schema)
    return got


def _config_errors(module, config_type, data):
    try:
        module.validate_config(config_type, data)
    except module.ValidationError as exc:
        return exc.errors
    return []


def _both_config(name, data):
    got = _config_errors(port, port.ConfigType(name), data)
    assert got == _config_errors(ref, ref.ConfigType(name), data)
    return got


def test_scalar_types():
    schema = {"type": "map", "mapping": {
        "a": {"type": "str"}, "b": {"type": "int"}, "c": {"type": "bool"},
        "d": {"type": "number"}}}
    assert _both({"a": "x", "b": 1, "c": True, "d": 2.5}, schema) == []
    assert len(_both({"a": 1, "b": "x", "c": 2, "d": "y"}, schema)) == 4


def test_bool_is_not_int():
    schema = {"type": "map", "mapping": {"n": {"type": "int"}}}
    assert _both({"n": True}, schema)


def test_unknown_key_rejected_strict():
    schema = {"type": "map", "mapping": {"a": {"type": "str"}}}
    assert any("unknown key" in e for e in _both({"a": "x", "zz": 1},
                                                 schema))


def test_allow_unknown():
    schema = {"type": "map", "allow_unknown": True, "mapping": {}}
    assert _both({"anything": 1}, schema) == []


def test_required_key():
    schema = {"type": "map", "mapping": {
        "a": {"type": "str", "required": True}}}
    assert any("required" in e for e in _both({}, schema))


def test_enum_pattern_range():
    schema = {"type": "map", "mapping": {
        "e": {"type": "str", "enum": ["x", "y"]},
        "p": {"type": "str", "pattern": "[a-z]+"},
        "r": {"type": "int", "range": {"min": 1, "max": 5}}}}
    assert _both({"e": "x", "p": "abc", "r": 3}, schema) == []
    assert len(_both({"e": "z", "p": "ABC", "r": 9}, schema)) == 3


def test_seq_and_nullable():
    schema = {"type": "map", "mapping": {
        "s": {"type": "seq", "sequence": {"type": "int"}},
        "n": {"type": "str", "nullable": True}}}
    assert _both({"s": [1, 2], "n": None}, schema) == []
    assert _both({"s": [1, "x"]}, schema)


def test_pool_schema_good():
    assert _both_config("pool", {"pool_specification": {
        "id": "mypool", "tpu": {"accelerator_type": "v5litepod-16"}}}) == []
    assert _both_config("pool", {"pool_specification": {
        "id": "h100pool", "substrate": "localhost",
        "vm_configuration": {"vm_size": "a3-highgpu-8g",
                             "vm_count": {"dedicated": 2}}}}) == []


def test_pool_schema_bad_key():
    config = {"pool_specification": {"id": "mypool", "not_a_real_key": 1}}
    with pytest.raises(port.ValidationError) as exc:
        port.validate_config(port.ConfigType.POOL, config)
    assert "not_a_real_key" in str(exc.value)
    assert _both_config("pool", config) == exc.value.errors


def test_substrate_enum_is_the_references():
    """tpu_vm passes the schema (the cloud substrate: A3 VMs)."""
    for kind in ("tpu_vm", "fake", "localhost"):
        assert _both_config("pool", {"pool_specification": {
            "id": "p", "substrate": kind}}) == []
    assert _both_config("pool", {"pool_specification": {
        "id": "p", "substrate": "gce_h100"}})


def test_jobs_schema_good():
    config = {"job_specifications": [{
        "id": "job1",
        "tasks": [{
            "docker_image": "busybox",
            "command": "echo hi",
            "multi_instance": {
                "num_instances": 4,
                "jax_distributed": {"enabled": True, "transport": "ici"},
            },
        }],
    }]}
    assert _both_config("jobs", config) == []


def test_credentials_schema():
    good = {"credentials": {
        "gcp": {"project": "my-proj"},
        "storage": {"backend": "localfs", "root": "/tmp/x"}}}
    assert _both_config("credentials", good) == []
    bad = {"credentials": {"storage": {"backend": "s3"}}}
    with pytest.raises(port.ValidationError):
        port.validate_config(port.ConfigType.CREDENTIALS, bad)
    assert _both_config("credentials", bad)


@pytest.mark.parametrize("name", [ct.value for ct in ref.ConfigType])
def test_schemas_are_the_references(name):
    """The port's own copy of each schema, read from next to its own
    validator, equal to the reference's key for key."""
    assert port._SCHEMA_DIR != ref._SCHEMA_DIR
    assert port._SCHEMA_DIR.parent == pathlib.Path(port.__file__).parent
    assert port._load_schema(name) == ref._load_schema(name)
    assert [ct.value for ct in port.ConfigType] == [
        ct.value for ct in ref.ConfigType]


def test_federation_logging_block_placement():
    good = {"federation": {"proxy_options": {
        "polling_interval": {"federations": 5, "actions": 1},
        "logging": {"level": "debug", "persistence": True}}}}
    assert _both_config("federation", good) == []
    bad = {"federation": {"proxy_options": {
        "polling_interval": {"actions": 1, "level": "debug"}}}}
    with pytest.raises(port.ValidationError):
        port.validate_config(port.ConfigType.FEDERATION, bad)
    assert _both_config("federation", bad)


@pytest.mark.parametrize(
    "path", sorted(RECIPES.glob("*/config/*.yaml")),
    ids=lambda p: f"{p.parent.parent.name}/{p.name}")
def test_recipe_config_errors_equal_the_references(path):
    with open(path, "r", encoding="utf-8") as fh:
        data = yaml.safe_load(fh)
    assert _both_config(path.stem, data) == []


def test_tpu_pool_passes_the_schema_and_is_refused_by_settings():
    config = {"pool_specification": {
        "id": "tpupool", "substrate": "fake",
        "tpu": {"accelerator_type": "v5litepod-16", "num_slices": 2}}}
    assert _both_config("pool", config) == []
    with pytest.raises(ValueError, match="a3-highgpu-1g") as exc:
        settings.pool_settings(config)
    assert "pool_specification.tpu" in str(exc.value)


def test_pool_services_are_accepted():
    """pool_services.schedules / autoscale pass the schema and the port's
    settings (node 0's agent runs them)."""
    config = {"pool_specification": {
        "id": "svc", "substrate": "fake",
        "vm_configuration": {"vm_size": "a3-highgpu-1g",
                             "vm_count": {"dedicated": 1}},
        "autoscale": {"enabled": True, "formula": "1"},
        "pool_services": {"schedules": True, "autoscale": True,
                          "poll_interval_seconds": 0.5}}}
    assert _both_config("pool", config) == []
    pool = settings.pool_settings(config)
    assert pool.pool_services.schedules and pool.pool_services.autoscale
    assert pool.pool_services.poll_interval_seconds == 0.5
