"""Auxiliary subsystems: profiling."""
