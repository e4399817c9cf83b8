"""Task factories: expand one task spec into many.

The port's copy of batch_shipyard_tpu/jobs/task_factory.py.

Reference analog: convoy/task_factory.py generate_task(:305) with
factory kinds ``custom`` (user module import :319), ``file`` (enumerate
objects :348), ``repeat`` (:393), ``random`` (:398 — uniform/randint/
and the distribution zoo), ``parametric_sweep`` (:409 — product /
product_iterables / combinations / permutations / zip).

The expansion is substrate-independent (it was the one piece of the
reference that ports unchanged in spirit); ``file`` enumerates our
state store objects instead of Azure blobs.
"""

from __future__ import annotations

import importlib
import itertools
import random as _random
from typing import Any, Iterator, Optional

from batch_shipyard_tpu_torch.state.base import StateStore


def _format_command(template: str, args) -> str:
    if isinstance(args, dict):
        return template.format(**args)
    if isinstance(args, (list, tuple)):
        return template.format(*args)
    return template.format(args)


def _random_generator(spec: dict) -> Iterator[Any]:
    distribution = spec.get("distribution", "uniform")
    count = spec.get("generate", 1)
    seed = spec.get("seed")
    rng = _random.Random(seed)
    dist_args = spec.get(distribution, {})
    for _ in range(count):
        if distribution == "uniform":
            yield rng.uniform(dist_args.get("a", 0.0),
                              dist_args.get("b", 1.0))
        elif distribution == "randint":
            yield rng.randint(dist_args["a"], dist_args["b"])
        elif distribution == "triangular":
            yield rng.triangular(
                dist_args.get("low", 0.0), dist_args.get("high", 1.0),
                dist_args.get("mode",
                              (dist_args.get("low", 0.0) +
                               dist_args.get("high", 1.0)) / 2))
        elif distribution == "beta":
            yield rng.betavariate(dist_args["alpha"], dist_args["beta"])
        elif distribution == "exponential":
            yield rng.expovariate(dist_args["lambda"])
        elif distribution == "gamma":
            yield rng.gammavariate(dist_args["alpha"], dist_args["beta"])
        elif distribution == "gauss":
            yield rng.gauss(dist_args["mu"], dist_args["sigma"])
        elif distribution == "lognormal":
            yield rng.lognormvariate(dist_args["mu"], dist_args["sigma"])
        elif distribution == "pareto":
            yield rng.paretovariate(dist_args["alpha"])
        elif distribution == "weibull":
            yield rng.weibullvariate(dist_args["alpha"],
                                     dist_args["beta"])
        else:
            raise ValueError(
                f"unknown random distribution {distribution!r}")


def _sweep_generator(spec: dict) -> Iterator[Any]:
    kind = spec.get("generator", "product")
    if kind == "product":
        axes = []
        for param in spec["product"]:
            if "values" in param:
                axes.append(list(param["values"]))
            else:
                start, stop, step = (param["start"], param["stop"],
                                     param.get("step", 1))
                axes.append(list(range(start, stop, step)))
        yield from itertools.product(*axes)
    elif kind == "product_iterables":
        yield from itertools.product(*spec["product_iterables"])
    elif kind == "combinations":
        yield from itertools.combinations(
            spec["combinations"]["iterable"],
            spec["combinations"]["length"])
    elif kind == "permutations":
        yield from itertools.permutations(
            spec["permutations"]["iterable"],
            spec["permutations"].get("length"))
    elif kind == "zip":
        yield from zip(*spec["zip"])
    else:
        raise ValueError(f"unknown sweep generator {kind!r}")


def _file_generator(spec: dict, store: Optional[StateStore]
                    ) -> Iterator[dict]:
    if store is None:
        raise ValueError("file task factory requires a state store")
    prefix = spec.get("prefix", "")
    for key in store.list_objects(prefix):
        name = key[len(prefix):].lstrip("/") if prefix else key
        yield {"url": key, "file_path": key,
               "file_path_with_container": key, "file_name": name,
               "file_name_no_extension": name.rsplit(".", 1)[0]}


def _custom_generator(spec: dict) -> Iterator[Any]:
    module = importlib.import_module(spec["module"])
    if spec.get("package"):
        module = importlib.import_module(spec["module"], spec["package"])
    yield from module.generate(*spec.get("input_args", []),
                               **spec.get("input_kwargs", {}))


def expand_task_factory(raw_task: dict,
                        store: Optional[StateStore] = None,
                        ) -> Iterator[dict]:
    """Yield concrete task dicts from a (possibly factory) task spec."""
    factory = raw_task.get("task_factory")
    if not factory:
        yield dict(raw_task)
        return
    base = {k: v for k, v in raw_task.items() if k != "task_factory"}
    command = base.get("command", "")
    if "repeat" in factory:
        for _ in range(int(factory["repeat"])):
            yield dict(base)
    elif "parametric_sweep" in factory:
        for args in _sweep_generator(factory["parametric_sweep"]):
            task = dict(base)
            task["command"] = _format_command(command, args)
            yield task
    elif "random" in factory:
        for value in _random_generator(factory["random"]):
            task = dict(base)
            task["command"] = _format_command(command, value)
            yield task
    elif "file" in factory:
        for file_info in _file_generator(factory["file"], store):
            task = dict(base)
            task["command"] = _format_command(command, file_info)
            # The enumerated object becomes task input data. Copy the
            # base list — dict(base) is shallow and a shared list would
            # accumulate every enumerated file onto every task.
            task["input_data"] = list(base.get("input_data", [])) + [{
                "kind": "statestore", "key": file_info["url"],
                "file_path": file_info["file_name"]}]
            yield task
    elif "custom" in factory:
        for args in _custom_generator(factory["custom"]):
            task = dict(base)
            task["command"] = _format_command(command, args)
            yield task
    else:
        raise ValueError(
            f"unknown task factory kind: {sorted(factory)}")
