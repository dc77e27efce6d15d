"""Scenario layer of the port: specs, presets and workload materialization
(copies of the reference's plain-Python modules)."""
