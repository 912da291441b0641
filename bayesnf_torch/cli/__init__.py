"""Experiment harness: the dataset registry and the evaluation CLI."""
