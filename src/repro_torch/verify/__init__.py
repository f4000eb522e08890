"""Conformance tooling of the port: comparison policies and the paper-parity
gate (counterpart of ``repro.verify``)."""
