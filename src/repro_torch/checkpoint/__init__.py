"""Checkpoints of engine state and of the cohort engine's host store."""
