"""The serving engine's device gate (models/serving.py ``_DeviceGate``):
a CUDA-graph capture holds the card alone against every other engine's
steps in the process. The gate is host code; these tests drive it with
threads on the CPU. The captures it orders run on the card only
(chip_smoke.py's cold-engine check)."""

import threading
import time
import types

import pytest
import torch

from batch_shipyard_tpu_torch.models import serving

WAIT_S = 0.2


def _holder(gate, mode, entered, release):
    with getattr(gate, mode)():
        entered.set()
        release.wait(10)


def _start(gate, mode):
    entered, release = threading.Event(), threading.Event()
    thread = threading.Thread(target=_holder,
                              args=(gate, mode, entered, release))
    thread.start()
    return thread, entered, release


@pytest.mark.parametrize("first,second,blocks", [
    ("shared", "shared", False),
    ("shared", "exclusive", True),
    ("exclusive", "shared", True),
    ("exclusive", "exclusive", True),
])
def test_gate_modes_exclude_as_stated(first, second, blocks):
    gate = serving._DeviceGate()
    t1, in1, out1 = _start(gate, first)
    assert in1.wait(5)
    t2, in2, out2 = _start(gate, second)
    if blocks:
        assert not in2.wait(WAIT_S)
    else:
        assert in2.wait(5)
    out1.set()
    assert in2.wait(5)
    out2.set()
    t1.join(5)
    t2.join(5)


def test_waiting_exclusive_holds_back_new_shared():
    """A capture waiting on a step is not starved by later steps."""
    gate = serving._DeviceGate()
    t1, in1, out1 = _start(gate, "shared")
    assert in1.wait(5)
    t2, in2, out2 = _start(gate, "exclusive")
    deadline = time.monotonic() + 5
    while gate._waiting != 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert gate._waiting == 1
    t3, in3, out3 = _start(gate, "shared")
    assert not in3.wait(WAIT_S)
    out1.set()
    assert in2.wait(5)
    assert not in3.wait(WAIT_S)
    out2.set()
    assert in3.wait(5)
    out3.set()
    for t in (t1, t2, t3):
        t.join(5)


def test_gate_reenters_within_a_thread():
    """warmup() holds it alone and its steps and captures re-enter;
    a capture asked for inside a shared step would wait on itself."""
    gate = serving._DeviceGate()
    with gate.exclusive():
        with gate.exclusive(), gate.shared():
            pass
        with gate.shared(), gate.shared():
            pass
    with gate.shared():
        with gate.shared():
            pass
        with pytest.raises(RuntimeError, match="inside"):
            with gate.exclusive():
                pass
    # Released: another thread takes it alone at once.
    t, entered, release = _start(gate, "exclusive")
    assert entered.wait(5)
    release.set()
    t.join(5)


def test_engine_picks_the_gate_by_device_and_graph():
    """A CUDA engine's step holds the gate alone until its decode graph
    is captured, and shares it after; a CPU engine passes freely."""
    device_work = serving.ContinuousBatcher._device_work
    card = types.SimpleNamespace(device=torch.device("cuda"))
    with device_work(card, True):
        assert serving._DEVICE_GATE._owner == threading.get_ident()
    with device_work(card, False):
        assert serving._DEVICE_GATE._shared == 1
        assert serving._DEVICE_GATE._owner is None
    assert serving._DEVICE_GATE._shared == 0
    host = types.SimpleNamespace(device=torch.device("cpu"))
    with serving._DEVICE_GATE.exclusive():
        done = []
        t = threading.Thread(target=lambda: done.append(
            device_work(host, True).__enter__() is None))
        t.start()
        t.join(5)
        assert done == [True]
