"""The port's copy of the state store (batch_shipyard_tpu/state): the
``StateStore`` interface, the in-memory and localfs stores, leases, the
factory, and the reference's names, so both packages read and write the
same rows, queues and objects."""
