"""The port's generic chaos drill (chaos/drill.run_drill) at the seeds and
arguments of tests/test_chaos_recovery.py:712 and :742, asserting what
those tests assert, on a GPU pool of four a3-highgpu-1g nodes (the
reference's v5litepod-16 is four hosts: the same plans). And the one
place the port's drill parts from the reference's: an output upload cut
by an injected store error. The agent records ``output_error`` and
finishes the task (it will not run it twice); the port's drill reports
the lost blob within the bound of the errors it injected, where the
reference's ``_check_invariants`` raises NotFoundError on the same rows.
The reference's drills are not rerun here: its own tests run them."""

import threading

import pytest

from batch_shipyard_tpu.chaos import drill as ref_drill
from batch_shipyard_tpu.chaos.plan import ChaosPlan as RefPlan
from batch_shipyard_tpu_torch.chaos import drill, injectors
from batch_shipyard_tpu_torch.chaos.plan import ChaosPlan
from batch_shipyard_tpu_torch.state.base import NotFoundError


def test_chaos_drill_acceptance_kinds():
    """test_chaos_recovery.py:712 on the port."""
    kinds = ("task_wedge", "task_kill", "node_preempt",
             "heartbeat_blackout")
    report = drill.run_drill(seed=5, kinds=kinds, wait_timeout=90.0)
    assert report["invariants"]["ok"]
    assert report["invariants"]["tasks"] == {"completed": 17}
    assert report["invariants"]["orphaned_gang_rows"] == 0
    assert report["invariants"]["queue_depth"] == 0
    applied = {a["kind"] for a in report["applied"]
               if a.get("applied")}
    assert applied == set(kinds), report["applied"]
    assert report["invariants"]["retries"] >= 1
    assert report["invariants"]["backoff_seconds"] > 0.0
    assert (ChaosPlan.generate(5, num_nodes=4, kinds=kinds)
            .fingerprint() == report["fingerprint"])
    # The plan the port's drill ran is the reference's.
    assert (RefPlan.generate(5, num_nodes=4, kinds=kinds)
            .fingerprint() == report["fingerprint"])
    assert report["invariants"]["lost_outputs"] == []


def test_chaos_drill_store_faults_survived():
    """test_chaos_recovery.py:742 on the port."""
    report = drill.run_drill(
        seed=11, tasks=8, duration=3.0, task_sleep=0.5,
        kinds=("store_delay", "store_error"),
        injections_per_kind=2, wait_timeout=60.0)
    assert report["invariants"]["ok"]
    assert report["invariants"]["tasks"] == {"completed": 9}
    applied = {a["kind"] for a in report["applied"]
               if a.get("applied")}
    assert applied == {"store_delay", "store_error"}
    assert len(report["invariants"]["lost_outputs"]) <= \
        report["invariants"]["injected_store_errors"]
    assert report["fingerprint"] == RefPlan.generate(
        11, duration=3.0, num_nodes=4,
        kinds=("store_delay", "store_error"),
        injections_per_kind=2).fingerprint()


class _UploadFaultStore(injectors.ChaosStore):
    """A ChaosStore whose injected errors land only on one regular task's
    stdout upload (and, with ``NOTE``, on the agent's note of that lost
    upload, the row's ``output_error``): the races the store-fault drill
    can hit, made certain. Once one upload has failed, no other upload
    meets the gate, so two uploads in flight cannot share the errors."""

    NOTE = False

    def __init__(self, inner) -> None:
        super().__init__(inner)
        self._cut: list[str] = []
        self._cut_lock = threading.Lock()

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name == "put_object_stream":
            def upload(key, *args, **kwargs):
                if key.endswith("/stdout.txt") and key.count("/") == 4:
                    with self._cut_lock:
                        if not self._cut:
                            try:
                                self._gate(name, key)
                            except injectors.ChaosError:
                                self._cut.append(key.split("/")[3])
                                raise
                return attr(key, *args, **kwargs)
            return upload
        if name == "merge_entity" and self.NOTE:
            def merge(table, pk, rk, props, *args, **kwargs):
                if "output_error" in props and rk in self._cut:
                    self._gate(name, table)
                return attr(table, pk, rk, props, *args, **kwargs)
            return merge
        return attr


class _UploadAndNoteFaultStore(_UploadFaultStore):
    NOTE = True


@pytest.mark.parametrize("store_cls,ops", [(_UploadFaultStore, 1),
                                           (_UploadAndNoteFaultStore, 2)],
                         ids=["upload", "upload-and-note"])
def test_output_upload_fault_reported_where_the_reference_raises(
        monkeypatch, store_cls, ops):
    seen = {}
    check = drill._check_invariants

    def capture(store, task_rows, expected, report):
        seen.update(store=store, rows=task_rows, expected=expected)
        check(store, task_rows, expected, report)

    monkeypatch.setattr(drill.injectors_mod, "ChaosStore", store_cls)
    monkeypatch.setattr(drill, "_check_invariants", capture)
    plan = ChaosPlan.generate(3, duration=3.0, num_nodes=4,
                              kinds=("store_error",))
    plan = ChaosPlan.from_dict(dict(plan.to_dict(), injections=[
        dict(i.to_dict(), at=0.5, params={"ops": ops})
        for i in plan.injections]))
    report = drill.run_drill(tasks=8, task_sleep=0.5, plan=plan,
                             wait_timeout=60.0)
    invariants = report["invariants"]
    assert invariants["ok"]
    assert invariants["tasks"] == {"completed": 9}
    assert invariants["injected_store_errors"] == ops
    assert len(invariants["lost_outputs"]) == 1
    lost = invariants["lost_outputs"][0]
    key = f"taskdata/{drill.POOL_ID}/{drill.JOB_ID}/{lost}/stdout.txt"
    assert ("put_object_stream", key) in report["injected_errors"]
    row = next(r for r in seen["rows"] if r["_rk"] == lost)
    if store_cls.NOTE:
        # The agent's note fell to the second error: the chaos store's
        # record of the failed upload is what explains the loss.
        assert not row.get("output_error")
    else:
        assert injectors.INJECTED_ERROR in row["output_error"]
    assert row["state"] == "completed" and row["exit_code"] == 0
    # The reference's check, applied to the same store and rows, demands
    # the blob its own agent let go.
    with pytest.raises(NotFoundError, match=f"{lost}/stdout.txt"):
        ref_drill._check_invariants(seen["store"], seen["rows"],
                                    seen["expected"],
                                    {"invariants": {}})


def _row(**cols):
    base = {"_rk": "t000", "state": "completed", "exit_code": 0,
            "output_error": injectors.INJECTED_ERROR}
    base.update(cols)
    return base


@pytest.mark.parametrize("row,successes,ok", [
    (_row(), 1, True),
    (_row(), 0, True),
    (_row(), None, True),
    (_row(output_error=None), 1, False),
    (_row(output_error=None, upload_faulted=True), 1, True),
    (_row(output_error=None, upload_faulted=True), 2, False),
    (_row(output_error=None, upload_faulted=True, exit_code=1), 1, False),
    (_row(output_error="disk full"), 1, False),
    (_row(output_error=injectors.OUTAGE_ERROR), 1, False),
    (_row(state="failed"), 1, False),
    (_row(exit_code=3), 1, False),
    (_row(attempt_history=[{"exit_code": 0}]), 1, False),
    (_row(attempt_history=[{"exit_code": -9}]), 1, True),
    (_row(), 2, False),
])
def test_lost_output_bound(row, successes, ok):
    row = dict(row)
    faulted = row.pop("upload_faulted", False)
    if ok:
        drill._check_lost_output(row, successes, upload_faulted=faulted)
    else:
        with pytest.raises(AssertionError):
            drill._check_lost_output(row, successes,
                                     upload_faulted=faulted)


def test_injected_store_errors_counts_applied_ops():
    plan = ChaosPlan.generate(11, duration=3.0, num_nodes=4,
                              kinds=("store_delay", "store_error"),
                              injections_per_kind=2)
    records = [{"kind": i.kind, "applied": n != 3}
               for n, i in enumerate(plan.injections)]
    report = {"plan": plan.to_dict(), "applied": records}
    want = sum(i.param("ops") for n, i in enumerate(plan.injections)
               if i.kind == "store_error" and n != 3)
    assert drill._injected_store_errors(report) == want
    assert drill._injected_store_errors(
        dict(report, applied=records[:1])) == sum(
            i.param("ops") for i in plan.injections[:1]
            if i.kind == "store_error")
