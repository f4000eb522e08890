"""SIL tables and losses (counterpart of ``repro.core``)."""
