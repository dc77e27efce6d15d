"""Core datatypes and simulator helpers the port's workload layer needs."""
