"""Shared scheduling policies (goodput-as-controller).

`sched.policy` holds the PURE decision functions — claim scoring,
victim selection, autoscale targets — imported by BOTH the live
agent/autoscale paths and the discrete-event fleet simulator
(`batch_shipyard_tpu_torch/sim/`), so the simulator exercises production
decision code rather than a fork of it.
"""
