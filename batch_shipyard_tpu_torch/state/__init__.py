"""The port's copy of the state store (batch_shipyard_tpu/state): the
``StateStore`` interface, the in-memory store, and the names the port's
pool hooks use."""
