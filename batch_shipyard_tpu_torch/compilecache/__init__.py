"""Warm start: the persistent cache of the port's kernel libraries,
AOT precompile and pool-wide cache seeding.

The port's copy of batch_shipyard_tpu/compilecache. Build time before
the first step is compile badput in the goodput decomposition, paid per
task, per node and per restart. This package removes it three ways:

  * **manager**: the cache dir ``ops/_build.py`` builds the ``nvcc``
    libraries into and loads them from, its identity key, and hit, miss
    and saved-seconds measurement for the goodput events;
  * **aot**: ``--aot-precompile`` builds and loads the step's libraries
    on a thread while the workload sets up its data and restore (and a
    serving engine captures its CUDA graphs from shapes,
    models/serving.ContinuousBatcher.precompile);
  * **seeding**: the node side exports each identity dir as a tar
    artifact to the state store after a task and seeds from it before
    the next.
"""

from batch_shipyard_tpu_torch.compilecache import aot  # noqa: F401
from batch_shipyard_tpu_torch.compilecache import seeding  # noqa: F401
from batch_shipyard_tpu_torch.compilecache.manager import (  # noqa: F401
    CACHE_DIR_ENV, CompileCacheManager, add_compile_cache_args,
    config_digest, current, enable, enable_from_args, identity_key,
    tracked)
